"""The GPipe pipeline over a stage axis of a rank mesh
(``repro_torch/runtime/pipeline.py``) in a gloo world of 4 on the CPU,
against the reference's ``pipeline_apply`` on 4 host devices (its own
test's case: a tanh MLP, 4 stages of 16x16, 6 microbatches of 8) at its
1e-5, and bitwise against the port's ``sequential_reference``.
"""
import pickle

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.launch import mesh as LM
from repro_torch.runtime import dist as D
from repro_torch.runtime.pipeline import pipeline_apply, sequential_reference

RNG = np.random.default_rng(11)
PARAMS = {"w": (RNG.standard_normal((4, 16, 16)) * 0.5).astype(np.float32),
          "b": np.zeros((4, 16), np.float32)}
MBS = RNG.standard_normal((6, 8, 16)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)          # tests/test_distributed.py's


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _params():
    return {k: torch.from_numpy(v) for k, v in PARAMS.items()}


def pipeline_ranks(rank, placed):
    """The pipeline on a (stage=4) rank mesh; with `placed` each stage
    passes only its own slice of the stacked params."""
    mesh = LM.make_mesh((4,), ("stage",), devices=["cpu"] * 4)
    params = _params()
    if placed:
        params = {k: v[rank:rank + 1].clone() for k, v in params.items()}
    return pipeline_apply(stage_fn, params, torch.from_numpy(MBS), mesh,
                          "stage")


_REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.launch import mesh as M
from repro.runtime.pipeline import pipeline_apply, sequential_reference
params, mbs = pickle.load(open(IN_PATH, 'rb'))
mesh = M.make_mesh((4,), ('stage',))
def stage_fn(p, x):
    return jnp.tanh(x @ p['w'] + p['b'])
params = {k: jnp.asarray(v) for k, v in params.items()}
out = pipeline_apply(stage_fn, params, jnp.asarray(mbs), mesh, 'stage')
ref = sequential_reference(stage_fn, params, jnp.asarray(mbs))
pickle.dump((np.asarray(out), np.asarray(ref)), open(OUT_PATH, 'wb'))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_pipe")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump((PARAMS, MBS), f)
    run_with_devices(_REF.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=4)
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=[False, True],
                ids=["stacked", "placed"])
def ranks(request):
    return [r.result for r in D.launch(pipeline_ranks, 4,
                                       args=(request.param,), timeout=120,
                                       threads=1)]


def test_pipeline_matches_reference(reference, ranks):
    out, ref_seq = reference
    np.testing.assert_allclose(out, ref_seq, **TOL)
    for got in ranks:
        np.testing.assert_allclose(got.numpy(), out, **TOL)


def test_pipeline_is_sequential_reference_bitwise(ranks):
    want = sequential_reference(stage_fn, _params(), torch.from_numpy(MBS))
    assert want.shape == MBS.shape
    for got in ranks:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_one_stage_is_the_stage_fn():
    """A stage axis of one (no world needed: a group of one) runs the
    M ticks alone."""
    class One:
        def group(self, _axis):
            return D.RankGroup((), (0,), 0)
    p = {k: v[:1] for k, v in _params().items()}
    got = pipeline_apply(stage_fn, p, torch.from_numpy(MBS), One(), "stage")
    assert torch.equal(got, sequential_reference(stage_fn, p,
                                                 torch.from_numpy(MBS)))
