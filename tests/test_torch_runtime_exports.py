"""The port's `runtime` package re-exports the four names of the JAX
package's `flash_attn_v100_tpu/runtime/__init__.py` (the README's serving
example starts `from ...runtime import ServingEngine`), each the object of
the port's own module, under the same `__all__`."""

import importlib

import pytest
import torch

import flash_attn_v100_tpu.runtime as jax_runtime
import flash_attn_v100_tpu_torch.runtime as runtime

torch.set_num_threads(1)

# name -> the port module that defines it
HOMES = {"PagedAllocator": "allocator", "Scheduler": "scheduler",
         "ServingEngine": "engine", "paged_forward": "engine"}


def test_all_equals_the_jax_packages():
    assert runtime.__all__ == jax_runtime.__all__
    assert sorted(HOMES) == sorted(jax_runtime.__all__)


@pytest.mark.parametrize("name", sorted(HOMES))
def test_name_is_its_modules_object(name):
    module = importlib.import_module(
        f"flash_attn_v100_tpu_torch.runtime.{HOMES[name]}")
    ns = {}
    exec(f"from flash_attn_v100_tpu_torch.runtime import {name}", ns)
    assert ns[name] is getattr(module, name)
    assert getattr(runtime, name) is getattr(module, name)
    assert module.__name__.startswith("flash_attn_v100_tpu_torch.")


def test_readme_serving_import():
    from flash_attn_v100_tpu_torch.runtime import (  # noqa: F401
        PagedAllocator, Scheduler, ServingEngine, paged_forward)
    assert ServingEngine.__module__ == (
        "flash_attn_v100_tpu_torch.runtime.engine")
