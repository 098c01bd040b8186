"""The port's train-path substrate, as ``tests/test_infra.py`` checks the
JAX package's: AdamW (convergence, clipping, the schedule; one update
equal to the JAX ``adamw.update``), the data pipeline (a pure function of
(seed, step, shard)), checkpoints (atomic, async, retention, restore onto
a like-shaped tree with each leaf's dtype kept, bf16 as its bits, the JAX
package's key layout both ways) and the fault-tolerance state machines
(the JAX package's copies, checked the same way)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint
from repro_torch.data import DataConfig, DataIterator, batch_for_step
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerWatchdog,
                                                     plan_remesh)
from repro_torch.optim import AdamWConfig, adamw

torch.set_num_threads(1)


# -- optimizer ----------------------------------------------------------------

class TestAdamW:
    def test_quadratic_convergence(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw.init(params)
        cfg = AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0,
                          total_steps=100, clip_norm=10.0)
        for _ in range(60):
            w = params["w"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(((w - 1.0) ** 2).sum(), (w,))
            params, state, _ = adamw.update({"w": g}, state, params, cfg)
        np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0],
                                   atol=0.05)

    def test_clipping(self):
        g = {"w": torch.tensor([3.0, 4.0])}       # norm 5
        clipped, gn = adamw.clip_by_global_norm(g, 1.0)
        assert float(gn) == pytest.approx(5.0)
        np.testing.assert_allclose(clipped["w"].numpy(), [0.6, 0.8],
                                   rtol=1e-6)

    def test_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
        step = lambda n: torch.tensor(n, dtype=torch.int32)
        assert float(adamw.schedule(step(0), cfg)) == pytest.approx(0.0)
        assert float(adamw.schedule(step(10), cfg)) \
            == pytest.approx(1.0, abs=0.02)
        assert float(adamw.schedule(step(100), cfg)) \
            == pytest.approx(0.1, abs=0.02)

    @pytest.mark.parametrize("n", [0, 1, 5, 10, 37, 100, 120])
    def test_schedule_matches_jax(self, n):
        cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        want = jax_adamw.schedule(jnp.int32(n), jax_adamw.AdamWConfig(
            **cfg._asdict()))
        got = adamw.schedule(torch.tensor(n, dtype=torch.int32), cfg)
        assert float(got) == pytest.approx(float(want), rel=1e-6)

    @pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "free"])
    def test_update_matches_jax(self, clip):
        """Three updates of a float32 tree (weight decay on, bias
        corrections, clipping or not) equal the JAX package's to float32
        rounding; the moments are float32 and the step int32 on both
        sides, and the port updates its tensors in place."""
        rng = np.random.default_rng(0)
        tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
        cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3,
                          clip_norm=clip)
        jcfg = jax_adamw.AdamWConfig(**cfg._asdict())
        jp = jax.tree.map(jnp.asarray, tree)
        js = jax_adamw.init(jp)
        tp = jax.tree.map(torch.from_numpy, tree)
        ts = adamw.init(tp)
        a = tp["a"]
        for i in range(3):
            g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
                np.float32), tree)
            jp, js, jm = jax_adamw.update(jax.tree.map(jnp.asarray, g), js,
                                          jp, jcfg)
            tp, ts, tm = adamw.update(jax.tree.map(torch.from_numpy, g), ts,
                                      tp, cfg)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-6)
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]),
                                                    rel=1e-6)
        assert tp["a"] is a and ts.step.dtype == torch.int32
        assert int(ts.step) == int(js.step) == 3
        for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            jax.tree.map(lambda w, t: np.testing.assert_allclose(
                t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8), want, got)
            assert all(t.dtype == torch.float32
                       for t in adamw.leaves(got))

    def test_bf16_params_update_in_float32(self):
        p = {"w": torch.tensor([1.0, -2.0], dtype=torch.bfloat16)}
        state = adamw.init(p)
        assert state.m["w"].dtype == torch.float32
        adamw.update({"w": torch.tensor([0.5, 0.5])}, state, p,
                     AdamWConfig(lr=0.1, warmup_steps=0))
        # step 1: m_hat / (sqrt(v_hat) + eps) = 1, plus decay 0.1 p
        want = torch.tensor([1.0 - 0.1 * 1.1, -2.0 - 0.1 * (1 - 0.2)])
        assert p["w"].dtype == torch.bfloat16
        torch.testing.assert_close(p["w"], want.to(torch.bfloat16))


# -- data pipeline --------------------------------------------------------------

class TestData:
    CFG = DataConfig(vocab_size=1000, seq_len=32, global_batch=8, seed=7)

    def test_deterministic_per_step(self):
        a = batch_for_step(self.CFG, 3)
        b = batch_for_step(self.CFG, 3)
        assert torch.equal(a["tokens"], b["tokens"])

    def test_steps_differ(self):
        a = batch_for_step(self.CFG, 3)
        b = batch_for_step(self.CFG, 4)
        assert not torch.equal(a["tokens"], b["tokens"])

    def test_shards_differ_and_partition(self):
        a = batch_for_step(self.CFG, 0, shard=0, n_shards=2)
        b = batch_for_step(self.CFG, 0, shard=1, n_shards=2)
        assert a["tokens"].shape[0] == 4
        assert not torch.equal(a["tokens"], b["tokens"])

    def test_iterator_resume_exact(self):
        it = DataIterator(self.CFG)
        seq = [next(it)["tokens"] for _ in range(6)]
        it2 = DataIterator(self.CFG, start_step=3)
        for i in range(3):
            assert torch.equal(next(it2)["tokens"], seq[3 + i])

    def test_labels_shifted(self):
        a = batch_for_step(self.CFG, 0)
        assert a["tokens"].shape == a["labels"].shape == (8, 32)
        assert a["tokens"].dtype == a["labels"].dtype == torch.int32
        assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
        assert (a["tokens"] < 1000).all() and (a["tokens"] >= 0).all()

    def test_low_ids_are_common_and_frontend_embeds(self):
        cfg = DataConfig(vocab_size=1000, seq_len=256, global_batch=8,
                         frontend_seq=5, d_model=16)
        a = batch_for_step(cfg, 0)
        # the Zipf-style draw before the (p - 1) mixing: the first
        # position is unmixed, and its ids concentrate low
        first = a["tokens"][:, 0].float()
        assert float(first.median()) < 1000 / 4
        assert a["frontend_embeds"].shape == (8, 5, 16)
        assert a["frontend_embeds"].dtype == torch.float32
        assert "frontend_embeds" not in batch_for_step(self.CFG, 0)


# -- checkpointing --------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((4, 4), generator=g),
                      "b": torch.zeros((4,))},
            "step_arrays": [torch.ones((2,)), torch.arange(3.0)]}


def _close(a, b):
    if isinstance(a, dict):
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _close(x, y)
    else:
        assert a.dtype == b.dtype
        torch.testing.assert_close(b, a, rtol=0, atol=0)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        checkpoint.save(str(tmp_path), 5, t, extra={"arch": "x"})
        restored, meta = checkpoint.restore(str(tmp_path), t)
        assert meta["step"] == 5 and meta["arch"] == "x"
        _close(t, restored)

    def test_latest_and_retention(self, tmp_path):
        for s in (1, 2, 3, 4, 10):
            checkpoint.save(str(tmp_path), s, _tree(s))
        assert checkpoint.latest_step(str(tmp_path)) == 10
        removed = checkpoint.apply_retention(str(tmp_path), keep=2,
                                             keep_period=2)
        left = checkpoint.available_steps(str(tmp_path))
        assert 10 in left and 4 in left and 2 in left
        assert 1 in removed and 3 in removed

    def test_tmp_dirs_invisible(self, tmp_path):
        """A killed writer (stale .tmp) must never be restored from."""
        os.makedirs(tmp_path / "step_000000007.tmp")
        assert checkpoint.latest_step(str(tmp_path)) is None
        checkpoint.save(str(tmp_path), 3, _tree())
        assert checkpoint.latest_step(str(tmp_path)) == 3

    def test_async_checkpointer(self, tmp_path):
        ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in range(4):
            ck.save(s, _tree(s))
        ck.wait()
        steps = checkpoint.available_steps(str(tmp_path))
        assert steps == [2, 3]

    def test_async_save_copies_before_the_thread(self, tmp_path):
        """The trainer updates its tensors in place right after a save:
        the checkpoint holds the values at the save."""
        t = _tree()
        want = torch.clone(t["layer"]["w"])
        ck = checkpoint.AsyncCheckpointer(str(tmp_path))
        ck.save(0, t)
        t["layer"]["w"].add_(1.0)
        ck.wait()
        restored, _ = checkpoint.restore(str(tmp_path), t)
        torch.testing.assert_close(restored["layer"]["w"], want)

    def test_restore_onto_a_shape_only_tree(self, tmp_path):
        t = _tree()
        checkpoint.save(str(tmp_path), 1, t)
        like = {"layer": {k: torch.empty_like(v, device="meta")
                          for k, v in t["layer"].items()},
                "step_arrays": [torch.empty(2, device="meta"),
                                torch.empty(3, device="meta")]}
        restored, _ = checkpoint.restore(str(tmp_path), like, device="cpu")
        _close(t, restored)

    def test_bf16_and_int_leaves_keep_their_dtype(self, tmp_path):
        t = {"w": torch.randn(5, 3).to(torch.bfloat16),
             "opt": adamw.init({"w": torch.zeros(5, 3)})}
        checkpoint.save(str(tmp_path), 2, t)
        meta = json.loads((tmp_path / "step_000000002" /
                           "meta.json").read_text())
        assert meta["bfloat16"] == ["w"]
        restored, _ = checkpoint.restore(str(tmp_path), t)
        _close(t, restored)
        assert isinstance(restored["opt"], adamw.AdamWState)
        assert restored["opt"].step.dtype == torch.int32

    def test_key_layout_matches_the_jax_package(self, tmp_path):
        """The same tree (params and an AdamW state) saves under the same
        keys in both packages, and each restores the other's files."""
        np_tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "n": {"b": np.ones(3, np.float32)}}
        jt = {"params": jax.tree.map(jnp.asarray, np_tree),
              "opt": jax_adamw.init(jax.tree.map(jnp.asarray, np_tree))}
        tt = {"params": jax.tree.map(torch.from_numpy, np_tree),
              "opt": adamw.init(jax.tree.map(torch.from_numpy, np_tree))}
        jax_checkpoint.save(str(tmp_path / "jax"), 4, jt)
        checkpoint.save(str(tmp_path / "port"), 4, tt)
        keys = [json.loads((tmp_path / d / "step_000000004" /
                            "meta.json").read_text())["keys"]
                for d in ("jax", "port")]
        assert keys[0] == keys[1] and "opt/m/n/b" in keys[0]
        restored, _ = checkpoint.restore(str(tmp_path / "jax"), tt)
        _close(tt, restored)
        back, _ = jax_checkpoint.restore(str(tmp_path / "port"), jt)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), jt,
                     back)


# -- fault tolerance state machines -------------------------------------------

class TestFaultTolerance:
    def test_heartbeat_detects_silent_host(self):
        hb = HeartbeatMonitor(n_hosts=4, timeout_s=10.0)
        for h in range(4):
            hb.beat(h, now=0.0)
        hb.beat(0, now=11.0)
        hb.beat(1, now=11.0)
        hb.beat(2, now=11.0)
        failed = hb.tick(now=12.0)
        assert failed == {3}
        assert hb.alive == [0, 1, 2]

    def test_remesh_keeps_model_axis(self):
        plan = plan_remesh((2, 16, 16), ("pod", "data", "model"),
                           surviving_chips=480, resume_step=100)
        assert plan.new_shape[-1] == 16
        assert plan.axis_names[-1] == "model"
        total = np.prod(plan.new_shape)
        assert total <= 480 and total % 16 == 0
        assert plan.resume_step == 100
        assert plan.batch_scale < 1.0

    def test_remesh_folds_lost_pod(self):
        plan = plan_remesh((2, 16, 16), ("pod", "data", "model"),
                           surviving_chips=256, resume_step=5)
        assert np.prod(plan.new_shape) == 256
        assert plan.new_shape[-1] == 16

    def test_remesh_impossible_raises(self):
        with pytest.raises(RuntimeError):
            plan_remesh((16, 16), ("data", "model"), surviving_chips=8,
                        resume_step=0)

    def test_straggler_ejection(self):
        wd = StragglerWatchdog(n_hosts=4, z_threshold=2.0,
                               strikes_to_eject=3)
        eject = False
        for step in range(10):
            for h in range(3):
                wd.observe(h, 1.0 + 0.01 * h)
            eject = wd.observe(3, 10.0 if step >= 4 else 1.0)
            if eject:
                break
        assert eject

    def test_steady_fleet_not_ejected(self):
        wd = StragglerWatchdog(n_hosts=4)
        for _ in range(50):
            for h in range(4):
                assert not wd.observe(h, 1.0 + 0.02 * h)
