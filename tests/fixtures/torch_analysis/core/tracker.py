# Planted REX001 corpus: a sync in the tracker's step and in its ranking.
# rex-expect: REX001=3
import torch


def _rank_galleries(d, valid):
    rows = torch.nonzero(valid)                      # planted: torch.nonzero
    return torch.argmin(d, dim=1), rows


def _track_step(st, d, valid):
    best, rows = _rank_galleries(d, valid)           # planted: via a helper
    done = st.done.tolist()                          # planted: .tolist()
    return best, rows, done


def make_queries(st):
    # not on the step's path: a sync is allowed
    return st.n_match.sum().item()
