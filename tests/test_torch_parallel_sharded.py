"""The port's meshes, head-sharded dense attention and LSE merge on 4 gloo
ranks (tests/torch_parallel_cases.py::parallel_body, one spawn for the
file) against the JAX package's sharded functions on the same-shaped mesh
of its virtual CPU devices: each rank's output block within 1e-5 of JAX's,
the gradients (every rank's summed over the mesh) within 1e-4 of
`jax.grad`, and `merge_lse_across` against a numpy merge, rows empty on
every shard included."""

import numpy as np
import pytest
import torch

import torch_parallel_cases as pc
import torch_parallel_jax as pj

torch.set_num_threads(1)

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pc.spawn("parallel_body", WORLD,
                    tmp_path_factory.mktemp("parallel"),
                    dict(dense=list(pc.DENSE_CASES), mesh=True))


def test_mesh_construction(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert m["shape"] == {"data": 1, "seq": 2, "model": 2}
        # model varies fastest: rank r sits at (seq r // 2, model r % 2)
        assert m["coords"] == {"data": 0, "seq": r // 2, "model": r % 2}
        # the seq line of rank r is {r % 2, r % 2 + 2}, the model line
        # {2 (r // 2), 2 (r // 2) + 1}
        assert m["sums"] == {"seq": 2 * (r % 2) + 2.0,
                             "model": 4 * (r // 2) + 1.0}
        assert m["shape2"] == {"data": 2, "seq": 1, "model": 2}
        assert m["coords2"] == {"data": r // 2, "seq": 0, "model": r % 2}


def test_hybrid_mesh_checks(ranks):
    for r, res in enumerate(ranks):
        h = res["hybrid"]
        # seq 4 over hosts of 2; data 3; seq 3 (does not divide 4 ranks);
        # hosts of 3 ranks (do not divide the world)
        assert h["errors"] == [True, True, True, True]
        assert h["shape"] == {"data": 2, "seq": 2, "model": 1}
        assert h["coords"] == {"data": r // 2, "seq": r % 2, "model": 0}


@pytest.mark.parametrize("name", list(pc.DENSE_CASES))
def test_head_sharded_dense_matches_jax(ranks, name):
    """The JAX package's test_head_sharded_dense (causal and not, also on
    data 2 x model 2) and test_head_sharded_kv_replicated, with their
    gradients."""
    pj.check_dense_against_jax(ranks, name)


def test_merge_lse_across_matches_numpy(ranks):
    o, lse = pc.merge_inputs()
    with np.errstate(invalid="ignore", divide="ignore"):
        m = lse.max(axis=0)
        m_safe = np.where(np.isfinite(m), m, 0.0)
        w = np.where(np.isfinite(lse), np.exp(lse - m_safe), 0.0)
        wsum = w.sum(axis=0)
        want_o = (o * w).sum(axis=0) / np.where(wsum == 0, 1.0, wsum)
        want_lse = np.where(wsum == 0, -np.inf,
                            m_safe + np.log(np.where(wsum == 0, 1.0, wsum)))
    for res in ranks:
        got = res["merge"]
        np.testing.assert_allclose(got["o"], want_o, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["lse"], want_lse, rtol=0, atol=1e-6)
        assert np.isneginf(got["lse"][0]).all() and not got["o"][0].any()
