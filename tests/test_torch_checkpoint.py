"""Checkpointing and fault tolerance on the torch port: the cases of
tests/test_checkpoint.py on ``repro_torch.distributed``'s jax-free
``CheckpointManager`` and ``StepRunner`` (atomic round trips, elastic
resharding, the keep-``N`` gc, the corruption quarantine with its
previous-step fallback, restore-on-failure), then the format shared with
the JAX package: the same leaf names in the same order as
``jax.tree_util.tree_flatten_with_path`` + ``keystr``, a snapshot written
by either package restored bit-equal by the other, a restore onto
torch tensors placed on their device, and bf16 trees (a bf16 leaf is its
2-byte bits viewed as ``V2`` with ``"dtype": "bfloat16"``, as JAX writes
it) both ways.  ``StepRunner`` takes a step's time after its loss is read
(on the card that is where the host waits) and re-raises a fault of the
card at once, with no restore.
"""

from __future__ import annotations

import json
import warnings
import time
from collections import namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.distributed.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager, _flatten  # noqa: E402
from repro_torch.distributed.fault import StepRunner  # noqa: E402
from repro_torch.errors import KernelLaunchError  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402


def small_tree(scale: float = 1.0):
    return {
        "cols": {
            "region": (np.arange(8, dtype=np.int32) * int(scale)),
            "rev": np.linspace(0.0, 7.0, 8).astype(np.float32) * scale,
        },
        "valid": np.array([True] * 6 + [False] * 2),
        "count": np.float64(42.0 * scale),
    }


def assert_tree_equal(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(np.asarray(got["count"]), want["count"])
    for k in want["cols"]:
        np.testing.assert_allclose(got["cols"][k], want["cols"][k])


class TestRoundTrip:
    def test_save_restore_round_trip_with_extra(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=2, keep=3)
        tree = small_tree()
        mgr.save(5, tree, extra={"seq": 5, "watermark": 2025.0})
        got, extra = mgr.restore(small_tree(0.0))
        assert_tree_equal(got, tree)
        assert extra["seq"] == 5
        assert extra["watermark"] == 2025.0

    def test_restore_specific_step(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=2, keep=5)
        mgr.save(1, small_tree(1.0), extra={"seq": 1})
        mgr.save(2, small_tree(2.0), extra={"seq": 2})
        got, extra = mgr.restore(small_tree(0.0), step=1)
        assert_tree_equal(got, small_tree(1.0))
        assert extra["seq"] == 1
        with pytest.raises(FileNotFoundError):
            mgr.restore(small_tree(0.0), step=9)

    def test_steps_exclude_tmp_and_corrupt(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=5)
        mgr.save(1, small_tree())
        (tmp_path / "step_00000002.tmp").mkdir()
        (tmp_path / "step_00000003.corrupt").mkdir()
        assert mgr.steps() == [1]
        assert mgr.latest_step() == 1

    def test_restore_empty_dir_raises(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        with pytest.raises(FileNotFoundError):
            mgr.restore(small_tree(0.0))


class TestElasticReshard:
    def test_two_shard_save_restores_under_one_shard_manager(self, tmp_path):
        """A 2-pod checkpoint restores onto a 1-pod job: the shard count is
        read from the manifest, not the restoring manager."""
        tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
                "b": np.float32(3.0)}
        CheckpointManager(tmp_path, n_shards=2, keep=3).save(10, tree)
        step_dir = tmp_path / "step_00000010"
        assert (step_dir / "shard_0.npz").exists()
        assert (step_dir / "shard_1.npz").exists()
        got, _ = CheckpointManager(tmp_path, n_shards=1).restore(
            {"w": np.zeros((8, 8), np.float32), "b": np.float32(0.0)})
        np.testing.assert_allclose(got["w"], tree["w"])
        np.testing.assert_allclose(np.asarray(got["b"]), 3.0)

    def test_shape_mismatch_is_an_error(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=2)
        mgr.save(1, {"w": np.zeros((8,), np.float32)})
        with pytest.raises(IOError):
            # strict=False still raises once every candidate is exhausted
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mgr.restore({"w": np.zeros((9,), np.float32)})


class TestGc:
    def test_keep_policy_drops_oldest(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=3)
        for s in range(1, 6):
            mgr.save(s, small_tree(float(s)))
        assert mgr.steps() == [3, 4, 5]
        got, _ = mgr.restore(small_tree(0.0))
        assert_tree_equal(got, small_tree(5.0))

    def test_gc_spares_quarantined_dirs(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=2)
        (tmp_path / "step_00000001.corrupt").mkdir()
        for s in range(2, 6):
            mgr.save(s, small_tree())
        assert (tmp_path / "step_00000001.corrupt").exists()
        assert mgr.steps() == [4, 5]


def corrupt_shard(tmp_path, step: int) -> None:
    shard = tmp_path / f"step_{step:08d}" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:-7] + b"garbage")


class TestQuarantine:
    def test_corrupt_latest_falls_back_to_previous(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=5)
        mgr.save(1, small_tree(1.0), extra={"seq": 1})
        mgr.save(2, small_tree(2.0), extra={"seq": 2})
        corrupt_shard(tmp_path, 2)
        with tracing() as tr, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, extra = mgr.restore(small_tree(0.0))
        assert_tree_equal(got, small_tree(1.0))
        assert extra["seq"] == 1
        # the bad step is quarantined, not deleted (post-mortem evidence)
        assert (tmp_path / "step_00000002.corrupt").exists()
        assert mgr.steps() == [1]
        assert tr.counters["ckpt.quarantined"] == 1

    def test_unreadable_manifest_falls_back(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=5)
        mgr.save(1, small_tree(1.0), extra={"seq": 1})
        mgr.save(2, small_tree(2.0), extra={"seq": 2})
        (tmp_path / "step_00000002" / "manifest.json").write_text("{not json")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, extra = mgr.restore(small_tree(0.0))
        assert extra["seq"] == 1

    def test_strict_restore_still_raises(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=5)
        mgr.save(1, small_tree(1.0))
        mgr.save(2, small_tree(2.0))
        corrupt_shard(tmp_path, 2)
        with pytest.raises(IOError, match="hash mismatch"):
            mgr.restore(small_tree(0.0), strict=True)
        # strict never quarantines — the evidence stays in place
        assert (tmp_path / "step_00000002").exists()

    def test_every_step_corrupt_raises(self, tmp_path):
        mgr = CheckpointManager(tmp_path, n_shards=1, keep=5)
        mgr.save(1, small_tree(1.0))
        corrupt_shard(tmp_path, 1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(IOError, match="failed to restore"):
                mgr.restore(small_tree(0.0))
        assert (tmp_path / "step_00000001.corrupt").exists()


class TestStepRunner:
    """Restore-on-failure: a mid-run crash rewinds state *and* the step
    counter to the last checkpoint, so with deterministic batches the
    final state is exactly the no-failure result."""

    @staticmethod
    def constant_batches():
        while True:
            yield np.float32(1.0)

    def test_failure_restores_and_converges(self, tmp_path):
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)
        calls = {"n": 0}
        failures = []

        def step_fn(acc, batch):
            calls["n"] += 1
            if calls["n"] == 8:  # crash once, after the step-6 checkpoint
                raise RuntimeError("device lost")
            return acc + batch, {"loss": float(np.sum(acc))}

        runner = StepRunner(step_fn, ckpt, ckpt_every=2, max_retries=3)
        state = runner.run((np.zeros(4, np.float32),), self.constant_batches(),
                           num_steps=10,
                           on_failure=lambda step, e: failures.append(step))
        np.testing.assert_allclose(state[0], np.full(4, 10.0))
        assert failures == [7]
        assert len(runner.history) >= 10

    def test_retry_budget_exhaustion_reraises(self, tmp_path):
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)

        def step_fn(acc, batch):
            raise RuntimeError("permanently poisoned")

        runner = StepRunner(step_fn, ckpt, ckpt_every=2, max_retries=2)
        with pytest.raises(RuntimeError, match="poisoned"):
            runner.run((np.zeros(4, np.float32),), self.constant_batches(),
                       num_steps=10)

    def test_step_time_covers_the_wait_for_the_loss(self, tmp_path):
        """A step on the card returns at once and its loss makes the host
        wait for the device: the step's time must include that wait."""

        class DeviceLoss:
            def __float__(self):
                time.sleep(0.05)  # the device finishing the step
                return 1.0

        runner = StepRunner(lambda acc, batch: (acc + batch, {"loss": DeviceLoss()}),
                            CheckpointManager(tmp_path, n_shards=1), ckpt_every=100)
        runner.run((np.zeros(4, np.float32),), self.constant_batches(), num_steps=3)
        assert [h.loss for h in runner.history] == [1.0] * 3
        assert min(h.seconds for h in runner.history) >= 0.05

    @pytest.mark.parametrize("fault", [KernelLaunchError("launch failed"),
                                       torch.OutOfMemoryError("out of memory")],
                             ids=["kernel", "oom"])
    def test_card_fault_reraises_with_no_restore(self, tmp_path, fault):
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)
        calls, failures = {"n": 0}, []

        def step_fn(acc, batch):
            calls["n"] += 1
            if calls["n"] == 3:  # after the step-2 checkpoint
                raise fault
            return acc + batch, {"loss": 0.0}

        runner = StepRunner(step_fn, ckpt, ckpt_every=2, max_retries=3)
        with pytest.raises(type(fault)):
            runner.run((np.zeros(4, np.float32),), self.constant_batches(), num_steps=10,
                       on_failure=lambda step, e: failures.append(step))
        assert calls["n"] == 3 and failures == [2] and len(runner.history) == 2


# ---------------------------------------------------------------------------
# the format shared with the JAX package
# ---------------------------------------------------------------------------

Pair = namedtuple("Pair", ["lo", "hi"])


def nested_tree():
    return {
        "state": {"cols": {"region": np.arange(4, dtype=np.int32),
                           "rev": np.linspace(0, 1, 4).astype(np.float32)},
                  "valid": np.array([True, False, True, True])},
        "pair": (np.float32(1.5), [np.zeros((2, 3), np.float32), None]),
        "named": Pair(np.int32(3), np.ones(2, np.float64)),
        "empty": None,
        "ints": {7: np.arange(3, dtype=np.int64), 2: np.int32(5)},
    }


class TestFormat:
    def test_leaf_names_and_order_match_jax(self):
        tree = nested_tree()
        items, _ = _flatten(tree)
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        assert [name for name, _ in items] == \
            [jax.tree_util.keystr(path) for path, _ in flat]
        for (_, got), (_, want) in zip(items, flat):
            assert got is want

    @pytest.mark.parametrize("writer,reader", [
        (JaxCheckpointManager, CheckpointManager),
        (CheckpointManager, JaxCheckpointManager),
    ], ids=["jax_to_port", "port_to_jax"])
    def test_snapshot_restores_under_the_other_package(self, tmp_path, writer, reader):
        tree = small_tree(3.0)
        writer(tmp_path, n_shards=2, keep=3).save(4, tree, extra={"seq": 4})
        manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
        assert sorted(manifest["leaves"]) == sorted(
            jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0])
        got, extra = reader(tmp_path, n_shards=1).restore(small_tree(0.0))
        assert extra == {"seq": 4}
        for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            w = np.asarray(want)
            g = np.asarray(leaf)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()

    def test_port_and_jax_write_the_same_npz_keys(self, tmp_path):
        tree = nested_tree()
        CheckpointManager(tmp_path / "port", n_shards=1).save(1, tree)
        JaxCheckpointManager(tmp_path / "jax", n_shards=1).save(1, tree)
        keys = [sorted(np.load(tmp_path / d / "step_00000001" / "shard_0.npz").files)
                for d in ("port", "jax")]
        assert keys[0] == keys[1]
        got, _ = CheckpointManager(tmp_path / "jax").restore(nested_tree())
        assert got["empty"] is None and got["pair"][1][1] is None
        assert isinstance(got["named"], Pair) and isinstance(got["pair"], tuple)
        np.testing.assert_array_equal(got["ints"][7], tree["ints"][7])

    def test_restore_onto_torch_targets_places_each_leaf(self, tmp_path):
        tree = small_tree(2.0)
        CheckpointManager(tmp_path, n_shards=2).save(3, tree)
        target = {"cols": {k: torch.zeros(8, dtype=torch.from_numpy(v).dtype)
                           for k, v in tree["cols"].items()},
                  "valid": torch.zeros(8, dtype=torch.bool),
                  "count": np.float64(0.0)}
        got, _ = CheckpointManager(tmp_path).restore(target)
        for k, v in tree["cols"].items():
            assert isinstance(got["cols"][k], torch.Tensor)
            assert got["cols"][k].device == target["cols"][k].device
            np.testing.assert_array_equal(got["cols"][k].numpy(), v)
        assert got["valid"].dtype == torch.bool
        assert isinstance(got["count"], np.ndarray)
        # a torch tree saves as its host arrays: the same bytes as numpy's
        CheckpointManager(tmp_path / "t", n_shards=1).save(1, got)
        back, _ = CheckpointManager(tmp_path / "t").restore(small_tree(0.0))
        assert_tree_equal(back, tree)


# ---------------------------------------------------------------------------
# bf16 trees
# ---------------------------------------------------------------------------


def bf16_bits(n: int, seed: int) -> np.ndarray:
    """n bf16 values as their uint16 bits: normals, ±0, ±inf, a NaN and
    subnormals among them."""
    rng = np.random.default_rng(seed)
    bits = rng.normal(0, 3, n).astype(ml_dtypes.bfloat16).view(np.uint16)
    bits[:6] = [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0x0001]
    return bits


def bf16_torch_tree():
    t = lambda bits: torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    return {"emb": t(bf16_bits(24, 1)).reshape(6, 4),
            "layers": {"w": t(bf16_bits(40, 2)).reshape(2, 4, 5)},
            "m": {"w": torch.arange(40, dtype=torch.float32).reshape(2, 4, 5)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


class TestBf16:
    def test_port_round_trip_is_bit_equal(self, tmp_path):
        tree = bf16_torch_tree()
        CheckpointManager(tmp_path, n_shards=2).save(1, tree)
        target = {"emb": torch.zeros(6, 4, dtype=torch.bfloat16),
                  "layers": {"w": torch.zeros(2, 4, 5, dtype=torch.bfloat16)},
                  "m": {"w": torch.zeros(2, 4, 5)}, "step": torch.tensor(0, dtype=torch.int32)}
        got, _ = CheckpointManager(tmp_path).restore(target)
        for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            assert leaf.dtype == want.dtype and leaf.shape == want.shape
            np.testing.assert_array_equal(_bits(leaf), _bits(want))

    def test_port_writes_what_jax_writes(self, tmp_path):
        """The manifest (dtype "bfloat16") and the npz keys are the JAX
        writer's, and JAX's ``np.load`` reads the port's bytes."""
        tree = bf16_torch_tree()
        jtree = {"emb": bf16_bits(24, 1).view(ml_dtypes.bfloat16).reshape(6, 4),
                 "layers": {"w": bf16_bits(40, 2).view(ml_dtypes.bfloat16).reshape(2, 4, 5)},
                 "m": {"w": np.arange(40, dtype=np.float32).reshape(2, 4, 5)},
                 "step": jnp.asarray(3, jnp.int32)}
        CheckpointManager(tmp_path / "port", n_shards=1).save(1, tree)
        JaxCheckpointManager(tmp_path / "jax", n_shards=1).save(1, jtree)
        step = "step_00000001"
        manifests = [json.loads((tmp_path / d / step / "manifest.json").read_text())
                     for d in ("port", "jax")]
        for m in manifests:
            del m["hashes"]
        assert manifests[0] == manifests[1]
        assert manifests[0]["leaves"]["['emb']"]["dtype"] == "bfloat16"
        shards = [np.load(tmp_path / d / step / "shard_0.npz") for d in ("port", "jax")]
        assert sorted(shards[0].files) == sorted(shards[1].files)
        for key in shards[1].files:
            a, b = shards[0][key], shards[1][key]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert shards[0]["['emb']"].dtype == np.dtype("V2")

    def test_jax_snapshot_restores_bit_equal(self, tmp_path):
        jtree = {"emb": bf16_bits(24, 1).view(ml_dtypes.bfloat16).reshape(6, 4),
                 "step": jnp.asarray(7, jnp.int32)}
        JaxCheckpointManager(tmp_path, n_shards=2).save(7, jtree, extra={"step": 7})
        target = {"emb": torch.zeros(6, 4, dtype=torch.bfloat16),
                  "step": torch.tensor(0, dtype=torch.int32)}
        got, extra = CheckpointManager(tmp_path).restore(target)
        assert extra == {"step": 7} and got["emb"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got["emb"]), bf16_bits(24, 1).reshape(6, 4))
        assert int(got["step"]) == 7

    def test_jax_restore_hands_back_raw_bits(self, tmp_path):
        """The reference's quirk (ROADMAP Queue 3): JAX's own restore of a
        bf16 leaf returns the ``|V2`` array it read, not bf16 values."""
        CheckpointManager(tmp_path, n_shards=1).save(1, bf16_torch_tree())
        got, _ = JaxCheckpointManager(tmp_path).restore(
            {"emb": np.zeros((6, 4), ml_dtypes.bfloat16),
             "layers": {"w": np.zeros((2, 4, 5), ml_dtypes.bfloat16)},
             "m": {"w": np.zeros((2, 4, 5), np.float32)}, "step": np.int32(0)})
        assert got["emb"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(got["emb"].view(np.uint16),
                                      bf16_bits(24, 1).reshape(6, 4))
