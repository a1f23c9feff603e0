"""The launch-bounds half of the port's static invariant plane
(``repro_torch.analysis.kernel_audit``) against the reference's
``repro.analysis.kernel_audit``: clean at HEAD, each property of the
geometry proof caught when a planner is broken on purpose, the guard
mirror's acceptances and refusals, the sentinel probes against the
reference's own probes in interpret mode (indices and sentinels bit for
bit, real scores within a few ulp), the launch table's
coverage of every Pallas kernel the reference captures, and the gate's
``--only kernel`` exit codes.  The compiled guards need ``nvcc`` and a
card: ``tests/test_torch_kernel_audit_cuda.py`` (``-m cuda``) and
``chip_smoke.py`` phase 23."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.analysis.kernel_audit as ref_audit
from repro_torch.analysis import kernel_audit as ka
from repro_torch.analysis.lint import Violation
from repro_torch.kernels import (decode_attention, flash_attention,
                                 mamba_scan, reid_topk)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(REPO, "scripts", "torch_check_invariants.py")


def _gate():
    spec = importlib.util.spec_from_file_location("torch_gate", GATE)
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    return gate


def test_audit_clean_at_head():
    findings = ka.audit_kernels()
    assert findings == [], "\n".join(map(str, findings[:20]))


def test_sweep_covers_every_config_at_full_width_and_every_sm_count():
    from repro_torch.configs import ARCH_IDS

    labels = {c.label for c in ka.full_widths()}
    attention = {a for a in ARCH_IDS if a not in ("falcon_mamba_7b",)}
    assert attention | {"falcon_mamba_7b"} <= labels
    kernels = {c.kernel for c in ka.sweep()}
    assert kernels == set(ka.KERNELS)
    assert ka.SM_COUNTS == (1, 16, 114, 132)


# -- planted faults: one per property of the proof ------------------------

def _split_overlap(monkeypatch):
    real = reid_topk.slices
    monkeypatch.setattr(reid_topk, "slices", lambda G, S: [
        (a, min(b + 64, G)) for a, b in real(G, S)])
    return "reid_topk_unmasked", dict(Q=256, G=8192, D=64, k=16), \
        "written 2 times"


def _split_gap(monkeypatch):
    real = reid_topk.slices
    monkeypatch.setattr(reid_topk, "slices", lambda G, S: [
        (a + (64 if i else 0), b) for i, (a, b) in enumerate(real(G, S))])
    return "reid_topk_segment_masked", dict(Q=256, G=8192, D=64, k=16,
                                            C=130), "written 0 times"


def _s_past_tiles(monkeypatch):
    monkeypatch.setattr(reid_topk, "split_plan",
                        lambda Q, G, n: (-(-Q // 64), -(-G // 64) + 1))
    return "reid_topk_tiles", dict(Q=100, G=700, D=16, k=2, C=120), \
        "guard refuses"


def _smem_past_max(monkeypatch):
    real = flash_attention.flash_plan
    monkeypatch.setattr(flash_attention, "flash_plan", lambda hd, dt: real(
        hd, dt)._replace(smem=ka.MAX_SMEM + 16))
    return "flash_attention", dict(B=2, H=4, KV=2, S=100, T=100, hd=64,
                                   causal=True), "past MAX_SMEM"


def _flash_grid_z(monkeypatch):
    return "flash_attention", dict(B=65536, H=1, KV=1, S=64, T=64, hd=64,
                                   causal=True), "grid (1, 1, 65536) outside"


def _decode_key_uncovered(monkeypatch):
    real = decode_attention.decode_plan

    def short(*a):
        p = real(*a)
        return p._replace(splits=p.splits - 1,
                          blocks=p.blocks // p.splits * (p.splits - 1))

    monkeypatch.setattr(decode_attention, "decode_plan", short)
    return "decode_attention", dict(B=2, H=8, KV=2, T=4096, hd=64,
                                    length=(4096, 100)), \
        "keys (B, H, key < length): element (0, 0, 3840) written 0 times"


def _scan_segment_gap(monkeypatch):
    real = mamba_scan.scan_plan
    monkeypatch.setattr(mamba_scan, "scan_plan", lambda *a: real(
        *a)._replace(seg_len=real(*a).seg_len - 8))
    return "mamba_scan", dict(B=1, L=4096, D=256, N=16, final_state=True), \
        "y (B, L, D): element"


def _int_offset(monkeypatch):
    # a plan of 2^16 slices over 2^16 q-blocks: the launcher forms the grid
    # nq * S in int
    monkeypatch.setattr(reid_topk, "split_plan",
                        lambda Q, G, n: (-(-Q // 64), 65536))
    return "reid_topk_unmasked", dict(Q=2 ** 22, G=2 ** 22, D=64, k=16), \
        "nq * S (the grid) reaches 4294967296, past INT_MAX"


def _decode_loaded_key(monkeypatch):
    # a cache at the bound on a warp's first key alone, T - 1 + 7 tiles of
    # 32 keys: the keys its loop and its loads step to are past INT_MAX
    T = 2 ** 31 - 224
    return "decode_attention", dict(B=1, H=1, KV=1, T=T, hd=8, length=(T,)), \
        "ld_t0 (the key issue() steps to, STAGES - 1 rounds ahead) " \
        "reaches 2147484160, past INT_MAX"


@pytest.mark.parametrize("plant", [
    _split_overlap, _split_gap, _s_past_tiles, _smem_past_max,
    _flash_grid_z, _decode_key_uncovered, _scan_segment_gap, _int_offset,
    _decode_loaded_key])
def test_planted_fault_is_reported(monkeypatch, plant):
    kernel, shape, want = plant(monkeypatch)
    findings = ka.check_launch(kernel, shape)
    assert findings, f"{plant.__name__}: no finding"
    assert all(isinstance(v, Violation) and v.rule == "KERNEL" and
               v.path.startswith("<cuda:") for v in findings)
    assert any(want in v.msg for v in findings), \
        "\n".join(str(v) for v in findings)


def test_planted_fault_fails_the_gate(monkeypatch):
    gate = _gate()
    assert gate.main(["--only", "kernel"]) == 0
    _split_overlap(monkeypatch)
    assert gate.main(["--only", "kernel"]) == 1


def test_gate_exits_zero_at_head_with_both_layers():
    r = subprocess.run([sys.executable, GATE], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=os.path.join(REPO,
                                                                    "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s) across layers [lint, kernel]" in r.stdout


# -- the guard mirror --------------------------------------------------------

def _cases_of(kernel, step=1):
    return [c for c in ka.sweep() if c.kernel == kernel and
            ka.launches_at_all(c)][::step]


@pytest.mark.parametrize("kernel", ka.KERNELS)
def test_mirror_accepts_the_planners_and_refuses_perturbations(kernel):
    n_plans = n_refused = 0
    for c in _cases_of(kernel, step=3):
        if ka.routed(c).kernel != kernel:
            continue
        for n_sms in ka.SM_COUNTS:
            args = ka.plan_args(c, n_sms)
            assert ka.launcher_accepts(kernel, args), (str(c), n_sms)
            n_plans += 1
            for label, bad in ka.perturbations(kernel, args):
                assert not ka.launcher_accepts(kernel, bad), \
                    (str(c), n_sms, label)
                n_refused += 1
    assert n_plans and n_refused


def test_mirror_refuses_each_named_field():
    flash = ka.plan_args(ka.case("flash_attention", B=1, H=4, KV=2, S=65,
                                 T=65, hd=64, causal=True), 132)
    for field, value in (("hd", 264), ("hd", 12), ("KV", 3), ("B", 65536),
                         ("stages", flash["stages"] + 1), ("q", ka.ADDR + 4)):
        assert not ka.launcher_accepts("flash_attention",
                                       dict(flash, **{field: value})), field
    dec = ka.plan_args(ka.case("decode_attention", "bfloat16", B=2, H=32,
                               KV=4, T=32768, hd=128, length=(32768, 5)), 132)
    assert dec["splits"] > 1
    for field, value in (("splits", dec["splits"] + 1),
                         ("splits", dec["splits"] - 1),
                         ("smem", dec["smem"] + 16), ("tile", dec["tile"] + 8),
                         ("ws", 0), ("counters", 0), ("hd", 264)):
        assert not ka.launcher_accepts("decode_attention",
                                       dict(dec, **{field: value})), field
    assert ka.launcher_accepts("decode_attention", dict(dec, counters=0,
                                                        combine=0))
    reid = ka.plan_args(ka.case("reid_topk_segment_masked", Q=256, G=8192,
                                D=64, k=16, C=130), 132)
    assert reid["S"] > 1
    for field, value in (("S", 129), ("S", 0), ("ws_i", 0), ("k", 17),
                         ("C", 4097)):
        assert not ka.launcher_accepts("reid_topk_segment_masked",
                                       dict(reid, **{field: value})), field
    scan = ka.plan_args(ka.case("mamba_scan", B=1, L=1024, D=256, N=16,
                                final_state=False), 132)
    assert scan["segs"] > 1
    for field, value in (("segs", scan["segs"] + 1), ("ws_p", 0),
                         ("chunk", scan["chunk"] + 4), ("eg", 2)):
        assert not ka.launcher_accepts("mamba_scan",
                                       dict(scan, **{field: value})), field


def test_routing_and_wrapper_refusals():
    assert reid_topk.camera_route(reid_topk.MAX_CAMS)[1] == \
        "reid_topk_segment_masked"
    assert reid_topk.camera_route(reid_topk.MAX_CAMS + 1)[1] == \
        "reid_topk_tiles"
    assert ka._routing_findings() == []
    with pytest.raises(ValueError):
        flash_attention.flash_plan(264, torch.float32)
    with pytest.raises(ValueError):
        decode_attention.check_width(12)


def test_zero_length_calls_answer_before_the_device_dispatch():
    for kernel in ("reid_topk_unmasked", "reid_topk_segment_masked",
                   "reid_topk_tiles"):
        extra = {} if kernel == "reid_topk_unmasked" else dict(C=8)
        for Q, G in ((0, 12), (4, 0)):
            c = ka.case(kernel, Q=Q, G=G, D=8, k=3, **extra)
            assert not ka.launches_at_all(c)
            assert ka._zero_length_findings(c) == []
        # a call that would launch reaches the dispatch, which has no kernel
        # for meta tensors
        c = ka.case(kernel, Q=4, G=12, D=8, k=3, **extra)
        assert ka._zero_length_findings(c), kernel


# -- the sentinel probes against the reference's -------------------------

def test_sentinel_probes_bit_equal_to_the_reference(monkeypatch):
    from repro.kernels import ops as ref_ops

    recorded = []
    for name in ("reid_topk", "reid_topk_masked", "reid_topk_segments",
                 "reid_topk_tiles"):
        real = getattr(ref_ops, name)

        def record(*args, _real=real, **kw):
            sv, si = _real(*args, **kw)
            recorded.append((np.asarray(sv), np.asarray(si)))
            return sv, si

        monkeypatch.setattr(ref_ops, name, record)
    assert ref_audit._sentinel_findings() == []
    findings, mine = ka.sentinel_probes("cpu")
    assert findings == []
    assert len(mine) == len(recorded) == 10
    for (label, sv, si), (rv, ri) in zip(mine, recorded):
        assert sv.dtype == rv.dtype and si.dtype == ri.dtype, label
        # indices and every sentinel slot bit for bit; a real candidate's
        # float32 score differs by the order its products are summed in
        # (the reference's dot against the plain version's depth order),
        # so within a few ulp
        assert np.array_equal(si, ri), label
        assert np.array_equal(sv == ka.ref.NEG_INF, rv == ka.ref.NEG_INF), \
            label
        np.testing.assert_array_max_ulp(sv, rv, maxulp=4)


def test_sentinel_probe_catches_a_wrong_sentinel(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.reid_topk_tiles

    def leaky(*a):
        sv, si = real(*a)
        return sv, torch.where(si < 0, torch.zeros_like(si), si)

    monkeypatch.setattr(ops, "reid_topk_tiles", leaky)
    findings, _ = ka.sentinel_probes("cpu")
    assert any("reid_topk_tiles" in v.msg for v in findings)


# -- coverage of the reference's Pallas kernels ---------------------------

def test_launch_table_covers_every_captured_pallas_kernel(monkeypatch):
    records = []
    real = ref_audit._capture_call

    def capture(fn, *a, **kw):
        recs = real(fn, *a, **kw)
        records.extend(recs)
        return recs

    monkeypatch.setattr(ref_audit, "_capture_call", capture)
    assert ref_audit._bounds_findings() == []
    captured = {r["kernel"] for r in records}
    assert len(captured) == 6, captured
    covered = {name for e in ka.LAUNCH_TABLE.values() for name in e.replaces}
    assert captured <= covered, captured - covered
    for name in captured:
        assert any(name in e.replaces and e.symbol
                   for e in ka.LAUNCH_TABLE.values()), name


def test_launch_table_names_sources_symbols_and_exports():
    csrc = os.path.join(REPO, "src", "repro_torch", "kernels")
    for key, e in ka.LAUNCH_TABLE.items():
        text = open(os.path.join(csrc, e.source)).read()
        if e.symbol:
            assert f'extern "C" int {e.symbol}(' in text, key
            assert f'extern "C" int {e.guard}(' in text, key
            assert e.pointers and e.ints
    assert set(ka.KERNELS) == {
        "reid_topk_segment_masked", "reid_topk_tiles", "reid_topk_unmasked",
        "flash_attention", "flash_attention_bwd", "decode_attention",
        "mamba_scan"}
    # the backward's two later passes are launched by its launcher
    for key in ("flash_bwd_dkdv", "flash_bwd_dq"):
        e = ka.LAUNCH_TABLE[key]
        assert e.symbol is None and e.source == "csrc/flash_attention_bwd.cu"
        assert e.replaces == ("_flash_kernel",)


# -- repairs: lengths past the kernels' int bounds -------------------------

def test_flash_refuses_lengths_past_its_int_bounds():
    """flash forms a block's row bound q0 + rows and its key tiles' bound
    kend + keys x splits - 1 in int: at S or T past ``MAX_LEN`` the wrapper
    raises before it reaches a launcher, and the guard refuses."""
    top = flash_attention.MAX_LEN
    q = torch.empty((1, 1, top + 1, 64), device="meta")
    kv = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="row and key bounds"):
        flash_attention.flash_attention(q, kv, kv)
    for hd, dtype in ((64, "float32"), (64, "bfloat16"), (256, "float32")):
        shape = dict(B=1, H=1, KV=1, S=top, T=top, hd=hd, causal=False)
        findings = ka.check_launch("flash_attention", shape, dtype)
        assert findings and all("too large to enumerate" in v.msg
                                for v in findings), findings
        findings = ka.check_launch("flash_attention",
                                   dict(shape, S=top + 1, T=top + 1), dtype)
        assert any("guard refuses" in v.msg for v in findings)
        # hd 64's plans reach the bound exactly: 64 rows and 128 keys a
        # step in float32, 128 rows in bfloat16
        assert (hd == 64) == any("past INT_MAX" in v.msg for v in findings)


def test_decode_refuses_caches_past_its_int_bound():
    """decode steps a warp's keys in int: the key it scores, t0, to under a
    round of warps tiles past its split's end, and the key it loads,
    ld_t0, STAGES - 1 rounds further.  Past ``MAX_KEYS`` keys the wrapper
    raises before it reaches a launcher and the guard refuses; at
    ``MAX_KEYS`` the proof holds; at the bound on the first key alone
    (2^31 - 224), in both dtypes, the loaded key passes INT_MAX and the
    guard refuses."""
    top = decode_attention.MAX_KEYS
    q = torch.empty((1, 1, 8), device="meta")
    kv = torch.empty((1, 1, top + 1, 8), device="meta")
    with pytest.raises(ValueError, match="the key a warp loads"):
        decode_attention.decode_attention(
            q, kv, kv, torch.ones(1, dtype=torch.int32, device="meta"))
    for dtype, keys in (("float32", 768), ("bfloat16", 384)):
        # the plan's own bound: MAX_KEYS in float32, whose tiles are wider
        shape = dict(B=1, H=1, KV=1, T=top, hd=8, length=(top,))
        args = ka.plan_args(ka.case("decode_attention", dtype, **shape), 132)
        assert decode_attention.STAGES * args["warps"] * args["tile"] == keys
        end = decode_attention.INT_MAX + 1 - keys
        shape = dict(shape, T=end, length=(end,))
        assert ka.check_launch("decode_attention", shape, dtype) == []
        findings = ka.check_launch("decode_attention",
                                   dict(shape, T=end + 1, length=(end + 1,)),
                                   dtype)
        assert any("guard refuses" in v.msg for v in findings), findings
        old = 2 ** 31 - 224
        findings = ka.check_launch("decode_attention",
                                   dict(shape, T=old, length=(old,)), dtype)
        assert any("guard refuses" in v.msg for v in findings), findings
        assert any("ld_t0" in v.msg and "past INT_MAX" in v.msg
                   for v in findings), findings
    worst = max(decode_attention.STAGES * p.warps * p.tile
                for hd in range(8, 257, 8)
                for dtype in (torch.float32, torch.bfloat16)
                for H, KV in ((1, 1), (8, 1), (32, 4), (40, 4))
                for p in [decode_attention.decode_plan(2, H, KV, 4096, hd,
                                                       dtype, 132)])
    assert top - 1 + worst == decode_attention.INT_MAX
