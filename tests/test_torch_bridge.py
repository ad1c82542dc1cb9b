"""JAX params -> port params -> numpy is bit-exact, and every path of the
JAX package's ``_flatten_params`` has its counterpart in the port."""
import jax
import numpy as np
import pytest

from repro.api.artifact import _flatten_params
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ATTN
from repro.models.model import init_params as jax_init_params
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_reduced_config


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "with_tail"])
def test_round_trip_is_bit_exact(variant):
    over = {"dtype": "bfloat16"} if variant == "bfloat16" else {}
    if variant == "with_tail":      # 3 layers of a 2-block pattern: 1 tail
        over = {"n_layers": 3, "block_pattern": (ATTN, ATTN)}
    jcfg = jax_reduced("qwen3_1_7b").with_overrides(**over)
    cfg = get_reduced_config("qwen3_1_7b").with_overrides(**over)
    params = jax_init_params(jax.random.PRNGKey(3), jcfg)
    flat = _flatten_params(params)

    port = to_torch(params, cfg)
    assert len(port["layers"]) == cfg.n_layers
    back = to_numpy(port, cfg)

    assert set(back) == set(flat)
    for path, a in flat.items():
        b = back[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_stacked_leaves_split_per_layer():
    cfg = get_reduced_config("qwen3_1_7b").with_overrides(
        n_layers=3, block_pattern=(ATTN, ATTN))
    params = jax_init_params(jax.random.PRNGKey(4), jax_reduced(
        "qwen3_1_7b").with_overrides(n_layers=3, block_pattern=(ATTN, ATTN)))
    flat = _flatten_params(params)
    port = to_torch(params, cfg)
    # layer i*P + p is period i of stack/pos<p>; the remainder is tail/<j>
    np.testing.assert_array_equal(port["layers"][0]["mixer"]["wq"].numpy(),
                                  flat["stack/pos0/mixer/wq"][0])
    np.testing.assert_array_equal(port["layers"][1]["ffn"]["w_up"].numpy(),
                                  flat["stack/pos1/ffn/w_up"][0])
    np.testing.assert_array_equal(port["layers"][2]["norm1"]["scale"].numpy(),
                                  flat["tail/0/norm1/scale"])
    np.testing.assert_array_equal(port["embed"].numpy(), flat["embed"])
