"""Sequence-sharded KV-cache attention on 4 gloo ranks, seq 2 x model 2 (one spawn
for the file; tests/torch_parallel_cases.py::decode_body): the JAX
package's test_parallel.py decode cases (a decode, T_new 3 with append
and rotary, window and ALiBi, int8 pages, a paged append landing in the
right shard) against its flash_attn_with_kvcache_sharded on the
same-shaped mesh.  Outputs and LSE within 1e-5, the updated cache shards
bit-equal."""

import pytest
import torch

import torch_parallel_cases as pc
import torch_parallel_jax as pj

torch.set_num_threads(1)

MESH = (1, 2, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pc.spawn("decode_body", 4, tmp_path_factory.mktemp("decode"),
                    dict(mesh=MESH))


@pytest.mark.parametrize("name", pc.DECODE_CASES)
def test_sharded_decode_matches_jax(ranks, name):
    pj.check_decode_against_jax(ranks, MESH, name)
