"""The port's training path (``repro_torch/data/synthetic.py``,
``launch/train.py``) against the reference's, on the CPU.

  * data: ``batch_for_step`` bit for bit the reference's over seeds,
    steps and shards, frontends included; the exact-resume and
    shard-disjointness cases of the reference's ``tests/test_system.py``;
  * the train step: ``make_train_step`` is ``adamw_update`` applied to
    ``lm_loss``'s own gradients, bit for bit; one step's loss and grad
    norm against the reference's ``jit_train_step`` in f32 (loss rtol
    1e-5, grad norm within 2^-7); the reference's
    ``test_training_decreases_loss`` (reduced gemma3-1b, 40 steps);
  * checkpoints: ``train_loop`` saves every ``ckpt_every`` steps, ``main
    --resume`` continues from the saved step with the same batches; the
    reference's ``restore_checkpoint`` reads the port's training
    checkpoint and the port the reference's, leaf for leaf bitwise; a
    stop signal mid-loop leaves a checkpoint at the next step and
    returns;
  * ``main`` needs a card unless it is asked for the CPU, and a pod axis
    (the compressed exchange in the step) raises NotImplementedError.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RC
from repro.configs import get_arch as ref_arch
from repro.data import synthetic as RS
from repro.launch import train as RTR
from repro.models import modules as RM
from repro.optim import AdamWConfig as RAdamWConfig
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as S
from repro_torch.launch import train as TR
from repro_torch.models import modules as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.runtime.sharding import ShardingPlan

PLAN = ShardingPlan(mesh=None)
ARCH = "gemma3-1b"
ARGS = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "32",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", [None, "audio", "vision"])
@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(0, 0, 0, 1), (3, 7, 1, 2), (11, 123456, 3, 4),
                          (2 ** 31 + 5, 2 ** 33, 0, 2)])
def test_batch_for_step_is_the_references(frontend, seed, step, shard,
                                          num_shards):
    kw = dict(vocab_size=1000, global_batch=8, seq_len=24, seed=seed)
    if frontend:
        kw.update(frontend=frontend, frontend_len=6, frontend_dim=16)
    got = S.batch_for_step(S.DataConfig(**kw), step, shard, num_shards)
    want = RS.batch_for_step(RS.DataConfig(**kw), step, shard, num_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["tokens"].shape == (8 // num_shards, 24)


def test_data_pipeline_exact_resume():
    dc = S.DataConfig(vocab_size=1000, global_batch=4, seq_len=16)
    ds = S.ShardedDataset(dc)
    for _ in range(5):
        next(ds)
    state = ds.state()
    assert state == {"step": 5}
    a = next(ds)
    ds2 = S.ShardedDataset(dc)
    ds2.restore(state)
    b = next(ds2)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_data_pipeline_shard_disjointness():
    dc = S.DataConfig(vocab_size=1000, global_batch=8, seq_len=16)
    s0 = S.batch_for_step(dc, 3, shard=0, num_shards=2)
    s1 = S.batch_for_step(dc, 3, shard=1, num_shards=2)
    assert s0["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])


# -- the train step ---------------------------------------------------------------

def _data_cfg(cfg, batch=2, seq=32, seed=0):
    return S.DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                        seq_len=seq, seed=seed)


def test_train_step_is_adamw_on_lm_loss_grads():
    cfg = get_arch(ARCH).reduced()
    tc = TR.TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2))
    state = TR.init_state(4, cfg, tc, PLAN, device="cpu")
    assert sorted(state) == ["opt", "params"]
    assert state["opt"]["mu"]["units"][0]["b0"]["attn"]["wq"].dtype == \
        torch.bfloat16 and int(state["opt"]["step"]) == 0
    batch = TR.batch_on(S.batch_for_step(_data_cfg(cfg), 0), "cpu")
    new, metrics = TR.make_train_step(cfg, tc, PLAN, device="cpu")(state,
                                                                   batch)
    assert sorted(metrics) == ["aux", "grad_norm", "loss", "lr", "xent"]
    flat = dict(CV.tree_items(state["params"]))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = T.lm_loss(CV.map_tree(lambda k, _v: leaves[k],
                                    state["params"]), cfg, batch, PLAN)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    opt = {"mu": dict(CV.tree_items(state["opt"]["mu"])),
           "nu": dict(CV.tree_items(state["opt"]["nu"])),
           "step": state["opt"]["step"]}
    p, o, om = adamw_update(flat, grads, opt, tc.opt, device="cpu")
    assert torch.equal(metrics["loss"], loss.detach())
    assert torch.equal(metrics["grad_norm"], om["grad_norm"])
    for k, v in CV.tree_items(new["params"]):
        assert torch.equal(v, p[k]), k
    for k, v in CV.tree_items(new["opt"]["mu"]):
        assert torch.equal(v, o["mu"][k]) and \
            torch.equal(dict(CV.tree_items(new["opt"]["nu"]))[k],
                        o["nu"][k]), k
    assert int(new["opt"]["step"]) == 1
    # the old state is left as it was
    assert torch.equal(dict(CV.tree_items(state["params"]))[k], flat[k])


def test_one_step_matches_the_references(monkeypatch):
    """One step of the reference's jit_train_step and the port's from the
    same params and batch, both in f32: loss rtol 1e-5, grad norm within
    2^-7 (one bf16 rounding of the flash backward), lr exact."""
    monkeypatch.setattr(RM, "COMPUTE_DTYPE", jnp.dtype("float32"))
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)
    rcfg, cfg = ref_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rtc = RTR.TrainConfig(opt=RAdamWConfig(lr=1e-3, warmup_steps=2))
    tc = TR.TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2))
    rstate = jax.device_get(RTR.init_state(jax.random.key(8), rcfg, rtc,
                                           RPlan(mesh=None)))
    batch = S.batch_for_step(_data_cfg(cfg, seed=8), 0)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rstep = RTR.jit_train_step(rcfg, rtc, RPlan(mesh=None), rstate, rb)
    rnew, rm = rstep(jax.tree.map(jnp.asarray, rstate), rb)
    flat = CV.tree_from_reference(rstate, "cpu")
    state = CV.map_tree(lambda k, _v: flat[k], rstate)
    new, m = TR.make_train_step(cfg, tc, PLAN, device="cpu")(
        state, TR.batch_on(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(rm["xent"]),
                               rtol=1e-5)
    assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
        <= 2.0 ** -7
    assert float(m["lr"]) == float(rm["lr"])
    assert int(new["opt"]["step"]) == int(rnew["opt"]["step"]) == 1


def test_training_decreases_loss():
    """The reference's tests/test_system.py::test_training_decreases_loss
    in the port: reduced gemma3-1b, B 8 x S 64, 40 steps at lr 2e-3 with
    10 warm-up steps."""
    cfg = get_arch(ARCH).reduced()
    dc = S.DataConfig(vocab_size=cfg.vocab_size, global_batch=8, seq_len=64)
    tc = TR.TrainConfig(opt=AdamWConfig(lr=2e-3, warmup_steps=10))
    losses = []
    TR.train_loop(cfg, dc, tc, PLAN, 40, log_every=100, device="cpu",
                  callback=lambda i, s, m, b: losses.append(float(
                      m["loss"])))
    assert len(losses) == 40 and all(np.isfinite(losses))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


# -- checkpoints, resume and the stop signal -----------------------------------------

def _recorder():
    seen = {}

    def cb(i, state, metrics, batch):
        seen[i] = ({k: v.clone() for k, v in batch.items()},
                   float(metrics["loss"]))
    return seen, cb


def test_checkpoint_and_resume_continue_with_the_same_batches(tmp_path):
    ck = str(tmp_path / "ck")
    seen, cb = _recorder()
    state, hist = TR.main(ARGS + ["--steps", "4", "--ckpt-dir", ck,
                                  "--ckpt-every", "2"], callback=cb)
    assert C.available_steps(ck) == [2, 4] and sorted(seen) == [0, 1, 2, 3]
    assert [i for i, _ in hist] == [0, 3]
    with open(os.path.join(ck, "step_00000002", "manifest.json")) as f:
        man = json.load(f)
    assert man["extra"] == {"data": {"step": 2}}
    assert "params/units/0/b0/attn/wq" in man["leaves"] and \
        "opt/mu/units/0/b0/attn/wq" in man["leaves"] and \
        "opt/step" in man["leaves"]
    # resume from step 2 alone: the same batches for steps 2 and 3
    rdir = str(tmp_path / "rd")
    os.makedirs(os.path.join(rdir, "step_00000002"))
    for f in os.listdir(os.path.join(ck, "step_00000002")):
        os.link(os.path.join(ck, "step_00000002", f),
                os.path.join(rdir, "step_00000002", f))
    seen2, cb2 = _recorder()
    restored, meta = TR.restore_state(rdir, PLAN, "cpu")
    assert meta == {"step": 2, "data": {"step": 2}}
    assert int(restored["opt"]["step"]) == 2
    state2, _ = TR.main(ARGS + ["--steps", "4", "--ckpt-dir", rdir,
                                "--ckpt-every", "2", "--resume"],
                        callback=cb2)
    assert sorted(seen2) == [2, 3]
    for i in (2, 3):
        for k, v in seen[i][0].items():
            assert torch.equal(seen2[i][0][k], v), (i, k)
    # the resumed run started from the restored (lossy) params: its losses
    # are near the uninterrupted run's
    assert abs(seen2[2][1] - seen[2][1]) < 1e-2
    assert C.available_steps(rdir) == [2, 4]
    assert int(state2["opt"]["step"]) == int(state["opt"]["step"]) == 4


def _as_bits(x):
    """A restored leaf as comparable numpy bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) \
            if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _same_leaves(a, b):
    fa, fb = dict(CV.tree_items(a)), dict(CV.tree_items(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = _as_bits(fa[k]), _as_bits(fb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


def test_training_checkpoints_cross_read(tmp_path):
    """The port's training checkpoint restores in the reference to the
    same leaves, bit for bit, as in the port; and the reference's in the
    port."""
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    TR.main(ARGS + ["--steps", "2", "--ckpt-dir", port_dir,
                    "--ckpt-every", "2"])
    got = C.restore_checkpoint(port_dir, device="cpu")
    want = RC.restore_checkpoint(port_dir)
    assert got[1] == want[1] == {"step": 2, "data": {"step": 2}}
    _same_leaves(got[0], want[0])
    RTR.main(["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "32",
              "--steps", "2", "--ckpt-dir", ref_dir, "--ckpt-every", "2"])
    want = RC.restore_checkpoint(ref_dir)
    got = C.restore_checkpoint(ref_dir, device="cpu")
    assert got[1] == want[1]
    _same_leaves(got[0], want[0])
    # and the port resumes from the reference's checkpoint
    state, meta = TR.restore_state(ref_dir, PLAN, "cpu")
    assert sorted(state) == ["opt", "params"] and meta["step"] == 2
    _, hist = TR.train_loop(get_arch(ARCH).reduced(),
                            _data_cfg(get_arch(ARCH).reduced()),
                            TR.TrainConfig(), PLAN, 3, start_state=state,
                            start_step=2, device="cpu")
    assert [i for i, _ in hist] == [2] and np.isfinite(hist[0][1])


def test_stop_signal_checkpoints_the_next_step_and_returns(tmp_path,
                                                           monkeypatch):
    ck = str(tmp_path / "ck")
    stoppers = []
    init = TR.GracefulStop.__init__

    def keep(self):
        init(self)
        stoppers.append(self)
    monkeypatch.setattr(TR.GracefulStop, "__init__", keep)

    def cb(i, state, metrics, batch):
        if i == 1:
            stoppers[-1]._handler()          # what SIGTERM does
    _, hist = TR.main(ARGS + ["--steps", "10", "--ckpt-dir", ck,
                              "--ckpt-every", "100"], callback=cb)
    assert C.available_steps(ck) == [2]
    assert [i for i, _ in hist] == [0]
    assert stoppers[-1]._old == {}           # the handlers are put back


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main(["--arch", ARCH, "--reduced", "--steps", "1"])


def test_pod_axis_exchange_is_not_ported():
    """A pod axis asks for the compressed exchange inside the step. It is
    ported now: ``main --mesh 2x1x1`` starts two gloo processes that
    train over the pod axis; a logical pod mesh in one process gives the
    state its residual, one a pod (stacked), and emulates the exchange;
    a MoE arch exchanges uncompressed, as in the reference."""
    _, hist = TR.main(ARGS + ["--steps", "1", "--mesh", "2x1x1"])
    assert [i for i, _ in hist] == [0] and np.isfinite(hist[0][1])
    from repro_torch.launch import mesh as LM
    mesh = LM.make_mesh((2, 1, 1), ("pod", "data", "model"),
                        devices=["cpu"] * 2)
    cfg = get_arch(ARCH).reduced()
    plan = TR.make_plan_for(cfg, mesh)
    state = TR.init_state(0, cfg, TR.TrainConfig(), plan, device="cpu")
    assert sorted(state) == ["opt", "params", "residual"]
    wq = "units/0/b0/attn/wq"
    res = dict(CV.tree_items(state["residual"]))[wq]
    assert res.shape == (2,) + dict(CV.tree_items(state["params"]))[wq].shape
    batch = TR.batch_on(S.batch_for_step(S.DataConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=32), 0), "cpu")
    new, m = TR.make_train_step(cfg, TR.TrainConfig(), plan,
                                device="cpu")(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert float(dict(CV.tree_items(new["residual"]))[wq].abs().max()) > 0
    # a MoE arch exchanges uncompressed, as in the reference
    moe = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    assert TR.has_moe(moe) and not TR.has_moe(get_arch(ARCH).reduced())
    TR.make_train_step(moe, TR.TrainConfig(), TR.make_plan_for(moe, mesh),
                       device="cpu")
