"""Sequence-sharded KV-cache attention on 4 gloo ranks, seq 4 x model 1 (one spawn
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

MESH = (1, 4, 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pc.spawn("decode_body", 4, tmp_path_factory.mktemp("decode"),
                    dict(mesh=MESH))


@pytest.mark.parametrize("name", pc.DECODE_CASES)
def test_sharded_decode_matches_jax(ranks, name):
    pj.check_decode_against_jax(ranks, MESH, name)
