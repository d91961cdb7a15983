"""The port's dry-run (``repro_torch/launch/dryrun.py``) on a host with no
card: DTensor steps on meta tensors over a fake process group.

* On a reduced config at a fake world of 4 (a 2 × 2 mesh), the per-device
  FLOPs are the analytic count of the products one rank computes.
* ``roofline_terms``' constant-free fields are JAX's, given the same
  vector (the constants themselves are an H100's, not a TPU v5e's).
* The CLI writes a record with per-device FLOPs, bytes, collective bytes
  by kind, memory and the roofline terms, and records a skipped cell.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
(its first line), which every later subprocess of this worker would
inherit: the import here saves and restores it.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

_saved = os.environ.get("XLA_FLAGS")
try:
    from repro.launch import dryrun as jax_dryrun  # noqa: E402
finally:
    if _saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _saved

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

from test_torch_spmd import ROOT  # noqa: E402

B, S, MICRO = 4, 32, 2


def _batch(b=B, s=S):
    return {k: torch.empty((b, s), dtype=d, device="meta")
            for k, d in (("tokens", torch.int32), ("labels", torch.int32), ("mask", torch.float32))}


def _even():
    """The reduced Qwen2 with heads that divide over model = 2 (4 heads, 2
    KV heads of 24), so each rank computes a quarter of every product."""
    return replace(get_reduced("qwen2-1.5b"), n_heads=4, n_kv_heads=2, d_head=24)


def test_xla_flags_are_restored_after_the_jax_import():
    assert os.environ.get("XLA_FLAGS") == _saved


def test_flops_per_device_are_the_analytic_count():
    """One rank's products on a (data 2, model 2) mesh: a row of B per data
    rank and microbatch, half of every projection's columns, half the heads
    and half the vocabulary.  Per layer the projections run forward and
    twice backward (dX and dW, no remat: the reduced config has it off);
    the attention's kv block is checkpointed, so Q·Kᵀ runs forward, again
    in the recompute and twice backward, and P·V forward and twice backward
    (the non-reentrant recompute stops once the tensors the backward reads
    are back, before P·V); the CE chunk is checkpointed too: its logits
    product forward, recomputed, and twice backward."""
    cfg = _even()
    got = dryrun.trace_cell(cfg, "train_4k", (2, 2), ("data", "model"), microbatch=MICRO,
                            batch_override=_batch())
    t = (B // MICRO // 2) * S                         # tokens a rank holds per microbatch
    d, hd, kvd, f, v = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head, \
        cfg.d_ff, cfg.vocab
    proj = 2 * t * d * (hd + 2 * kvd) // 2 + 2 * t * hd * d // 2 + 3 * 2 * t * d * f // 2
    heads = cfg.n_heads // 2
    qk = pv = 2 * (B // MICRO // 2) * heads * S * S * cfg.d_head
    ce = 2 * t * d * v // 2
    per_micro = cfg.n_layers * (3 * proj + 4 * qk + 3 * pv) + 4 * ce
    assert got["flops"] == MICRO * per_micro


def test_roofline_terms_constant_free_fields_match_jax():
    meta = {"kind": "train", "n_active_params": 1_543_569_408}
    vec = (2.7e14, 3.1e13, 5.0e10)
    got = dryrun.roofline_terms(vec, meta, 4096, 256, 256)
    want = jax_dryrun.roofline_terms(vec, meta, 4096, 256, 256)
    for k in ("model_flops_global", "model_flops_per_device", "useful_fraction",
              "flops_per_device", "bytes_per_device_accessed", "collective_bytes_per_device"):
        assert got[k] == want[k], k
    for kind in ("prefill", "decode"):
        m = dict(meta, kind=kind)
        assert dryrun.roofline_terms(vec, m, 32768, 32, 256)["model_flops_global"] == \
            jax_dryrun.roofline_terms(vec, m, 32768, 32, 256)["model_flops_global"]
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW) == (989e12, 3.35e12)
    assert got["t_compute_s"] == vec[0] / 989e12


def test_trace_cell_counts_collectives_memory_and_bytes():
    got = dryrun.trace_cell(_even(), "train_4k", (2, 2), ("data", "model"), microbatch=MICRO,
                            batch_override=_batch())
    kinds = got["collective_by_kind"]
    assert set(kinds) == {"all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor"}
    assert all(v["calls"] > 0 and v["bytes"] > 0 for v in kinds.values())
    assert sum(r["bytes"] for r in got["collectives"]) == sum(v["bytes"] for v in kinds.values())
    assert got["peak_bytes"] > 0 and got["bytes"] > got["flops"] / 1000


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cells_trace_on_a_fake_world(shape):
    cfg = replace(get_reduced("qwen2-1.5b"), n_layers=1)
    got = dryrun.trace_cell(cfg, shape, (2, 2), ("data", "model"))
    assert got["kind"] == shape.split("_")[0]
    assert got["flops"] > 0


def test_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "whisper-base", "--shape", "decode_32k", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rec = json.loads((tmp_path / "whisper-base__decode_32k__16x16.json").read_text())
    for k in ("flops_per_device", "bytes_per_device_accessed", "collective_bytes_per_device",
              "collective_by_kind", "device_mem_gib", "t_compute_s", "t_memory_s",
              "t_collective_s", "dominant", "roofline_fraction", "useful_fraction"):
        assert k in rec, k
    assert rec["chips"] == 256 and rec["kind"] == "decode"


def test_a_quadratic_cell_is_recorded_as_skipped(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", out_dir=tmp_path, verbose=False)
    assert "skipped" in rec
    assert json.loads((tmp_path / "qwen2-1.5b__long_500k__16x16.json").read_text()) == rec
    assert get_config("qwen2-1.5b").sub_quadratic is False


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_rwkv_scan_flops_are_the_scans_elementwise_work(kind, monkeypatch):
    """The analytic count of RWKV's uncounted scan work equals the elements
    that the scan's pointwise ops write, counted on a run of the reduced
    RWKV6 (the only (B, H, P, P) products and sums of its forward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.shapes import Shape
    from repro_torch.models import ssm
    from repro_torch.models.api import build_model

    cfg = get_reduced("rwkv6-1.6b")
    b, s, p = 2, 8, 64
    monkeypatch.setitem(dryrun.SHAPES, "tiny", Shape("tiny", s, b, kind))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    aten = torch.ops.aten
    state_shape = (b, cfg.d_model // p, p, p)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func._overloadpacket in (aten.mul, aten.add) and tuple(out.shape) == state_shape:
                self.n += out.numel()
            return out

    with torch.no_grad(), Count() as count:
        if kind == "prefill":
            ssm.rwkv_prefill(params, cfg, torch.zeros((b, s), dtype=torch.int32))
        else:
            ssm.rwkv_decode_step(params, cfg, ssm.rwkv_init_state(cfg, b),
                                 torch.zeros((b, 1), dtype=torch.int32))
    assert count.n > 0
    assert dryrun.rwkv_scan_flops(cfg, "tiny", (1, 1), ("data", "model")) == count.n
    assert dryrun.rwkv_scan_flops(get_reduced("qwen2-1.5b"), "tiny", (1, 1),
                                  ("data", "model")) == 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv_cells_solved_from_scan_probes_equal_the_eager_trace(kind, monkeypatch):
    """``trace_affine`` (how the CLI records RWKV's train and prefill cells:
    their time scan traced at 2 and 4 of its steps, a train step at 2 and
    3 of its microbatches) against the eager trace of the same cell, on
    the reduced RWKV6 (remat on, a CE of 16-token chunks) on a (data 2,
    model 2) mesh: a 48-token train cell of
    4 microbatches and a prefill of 4 rows give their FLOPs, bytes and
    collectives exactly, the peak within a quarter.  Decode cells are
    traced whole."""
    from repro_torch.configs.shapes import Shape

    cfg = replace(get_reduced("rwkv6-1.6b"), loss_chunk=16, remat=True)
    monkeypatch.setitem(dryrun.SHAPES, "tiny", Shape("tiny", 48, 8 if kind == "train" else 4,
                                                     kind))
    assert dryrun.traced_affine(cfg, "tiny")
    got = dryrun.trace_affine(cfg, "tiny", (2, 2), ("data", "model"))
    want = dryrun.trace_cell(cfg, "tiny", (2, 2), ("data", "model"))
    assert got["flops"] == want["flops"] > 0
    assert got["bytes"] == want["bytes"] > 0
    assert got["collective_by_kind"] == want["collective_by_kind"]
    assert got["collective_by_kind"]
    assert abs(got["peak_bytes"] - want["peak_bytes"]) <= 0.25 * want["peak_bytes"]
    assert not dryrun.traced_affine(cfg, "decode_32k")
    assert not dryrun.traced_affine(get_reduced("qwen2-1.5b"), "train_4k")


def test_hybrid_train_cell_solved_from_microbatch_probes_equals_the_eager_trace(monkeypatch):
    """``trace_affine`` on the hybrid family's train cells (how the CLI
    records Zamba2-7B × train_4k: the step traced at 2 and 3 microbatches
    and at two depths on the cell's residue modulo ``attn_every``, solved
    for the cell's m and depth) against the eager trace of the same cell:
    the reduced Zamba2 at 9 layers (the shared attention every 2; probes at
    3 and 5 layers) on a (data 2, model 2) mesh, a 32-token cell of 8 rows
    in 4 microbatches, gives its FLOPs, bytes and each collective kind's
    calls and bytes exactly, the peak within a quarter.  Its prefill and
    decode cells are traced whole."""
    from repro_torch.configs.shapes import Shape

    cfg = replace(get_reduced("zamba2-7b"), n_layers=9)
    monkeypatch.setitem(dryrun.SHAPES, "tiny", Shape("tiny", 32, 8, "train"))
    assert dryrun.traced_affine(cfg, "tiny") and dryrun.traced_affine(cfg, "train_4k")
    assert not dryrun.traced_affine(cfg, "prefill_32k")
    assert not dryrun.traced_affine(cfg, "decode_32k")
    assert dryrun._hybrid_depths(cfg) == (3, 5)
    assert dryrun._hybrid_depths(get_config("zamba2-7b")) == (9, 15)
    got = dryrun.trace_affine(cfg, "tiny", (2, 2), ("data", "model"))
    want = dryrun.trace_cell(cfg, "tiny", (2, 2), ("data", "model"))
    assert got["flops"] == want["flops"] > 0
    assert got["bytes"] == want["bytes"] > 0
    assert got["collective_by_kind"] == want["collective_by_kind"]
    assert got["collective_by_kind"]
    assert abs(got["peak_bytes"] - want["peak_bytes"]) <= 0.25 * want["peak_bytes"]
    assert "peak an estimate" in got["method"]


def test_hybrid_train_cell_on_the_multi_pod_mesh_plans_no_strided_placement(monkeypatch):
    """The reduced Zamba2's train cell on a (pod 2, data 2, model 2) fake
    world of 8, as the CLI records Zamba2-7B × train_4k on 2 × 16 × 16.
    The Mamba mixer runs per rank (``sharding.per_rank_mamba``: in_proj's
    output gathered over model and split on each rank's local tensor), and
    the blocks sum their inputs' partial gradients once: no DTensor op of
    the step, the Mamba layers' among them, outputs a ``_StridedShard``
    placement (a hook on ``OpDispatcher.wrap``, which wraps every op's
    local result in its output spec), and DTensor plans no redistribution
    by its graph search (a hook on the planner; it runs for strided
    specs).  Then ``trace_affine``'s counts, solved from probes at 3 and 5
    layers and 2 and 3 microbatches, equal the eager trace's of 7 layers
    and 4 microbatches, the peak within a quarter."""
    import torch.distributed.tensor._redistribute as redist
    from torch.distributed.tensor._dispatch import OpDispatcher
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.configs.shapes import Shape

    strided, searched = [], []
    wrap = OpDispatcher.wrap
    planner = redist.DTensorRedistributePlanner
    search = planner.generate_graph_based_transform_infos

    def wrapped(res, spec):
        for s in spec if isinstance(spec, (list, tuple)) else [spec]:
            if any(isinstance(p, _StridedShard) for p in getattr(s, "placements", ())):
                strided.append((tuple(s.placements), tuple(s.shape)))
        return wrap(res, spec)

    def searching(self, src, dst, shape):
        searched.append((src.placements, dst.placements))
        return search(self, src, dst, shape)

    monkeypatch.setattr(OpDispatcher, "wrap", staticmethod(wrapped))
    monkeypatch.setattr(planner, "generate_graph_based_transform_infos", searching)
    cfg = replace(get_reduced("zamba2-7b"), n_layers=7, remat=True)
    monkeypatch.setitem(dryrun.SHAPES, "tiny", Shape("tiny", 32, 16, "train"))
    mesh, axes = (2, 2, 2), ("pod", "data", "model")
    want = dryrun.trace_cell(cfg, "tiny", mesh, axes)
    assert not strided and not searched, (strided[:4], searched[:4])
    assert want["collective_by_kind"]["all_gather_into_tensor"]["calls"] > 0
    got = dryrun.trace_affine(cfg, "tiny", mesh, axes)
    assert got["flops"] == want["flops"] > 0
    assert got["bytes"] == want["bytes"] > 0
    assert got["collective_by_kind"] == want["collective_by_kind"]
    assert abs(got["peak_bytes"] - want["peak_bytes"]) <= 0.25 * want["peak_bytes"]
