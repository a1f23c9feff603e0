# Planted REX001 corpus: host syncs and heavy host numpy inside the serving
# round's hot functions, one line for each kind of sync.
# rex-expect: REX001=16
import functools

import numpy as np
import torch


def _to_host(*tensors):
    # not hot itself; a hot function that calls it syncs through it
    out = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream().synchronize()
    return [t.numpy() for t in out]


@functools.cache
def _anchors(n, device):
    # copied once a (n, device): a call to it is no sync site
    return torch.as_tensor(np.arange(n), device=device)


class FakeEngine:
    def _round_body(self, qs, feats, dev):
        live = qs.sum().item()                       # planted: .item()
        rows = qs.nonzero()                          # planted: .nonzero()
        host = feats.cpu()                           # planted: .cpu()
        ids = qs.tolist()                            # planted: .tolist()
        back = feats.to("cpu")                       # planted: .to("cpu")
        kept = feats.to(device="cpu")                # planted: .to(device=)
        torch.cuda.synchronize()                     # planted: device-wide
        (outcome,) = _to_host(feats)                 # planted: local helper
        scale = torch.tensor(0.5, device=dev)        # a constant: fine
        cast = torch.from_numpy(outcome).to(torch.float32)   # dtype: fine
        view = torch.as_tensor(outcome)              # host tensor: fine
        anchors = _anchors(8, dev)                   # cached helper: fine
        hits = np.nonzero(outcome)                   # host numpy: fine
        rank = torch.argsort(feats, dim=-1)          # stays on the card
        n = feats.numel()                            # metadata: fine
        audit = qs.any().item()                      # rex: disable=REX001
        return (live, rows, host, ids, back, kept, scale, cast, view,
                anchors, hits, rank, n, audit)

    def _plan_round(self, mask, tiles, thresh, dev):
        def dev_t(a):
            return torch.from_numpy(a).to(dev)

        adm = dev_t(mask)                            # planted: nested helper
        cells = dev_t(tiles)                         # planted: nested helper
        t = torch.tensor(thresh, device=dev)         # planted: host scalar
        q = torch.as_tensor(mask, device=dev)        # planted: host array
        done = torch.from_numpy(tiles).cuda()        # planted: .cuda()
        stream = torch.cuda.current_stream()
        stream.synchronize()                         # planted: one stream
        flat = q.view(-1).numpy()                    # planted: .numpy()
        order = np.argsort(flat)                     # planted: heavy numpy
        return adm, cells, t, done, order

    def _skip_round(self, qs):  # rex: disable=REX001
        # def-level suppression covers the whole body
        return qs.cpu().numpy().mean()

    def report(self, qs):
        # not a hot-path function name: syncs are allowed here
        return qs.sum().item(), qs.cpu().tolist()
