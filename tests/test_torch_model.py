"""Reduced qwen3 (float32) on JAX params carried across: the port's
prefill logits, then six paged decode steps over the same pools and
table, against the JAX ``Model`` on the CPU (its XLA path), at
atol = rtol = 1e-4 (float32 GEMMs and reductions in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params
from repro.models.paged_cache import init_paged_pools as jax_init_pools
from repro.models.paged_cache import \
    scatter_prefill_blocks as jax_scatter
from repro_torch.bridge import to_torch
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention, layers
from repro_torch.models.model import Model
from repro_torch.models.paged_cache import (init_paged_pools,
                                            scatter_prefill_blocks)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced("qwen3_1_7b")
    cfg = get_reduced_config("qwen3_1_7b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    # non-zero norm scales, so the 1 + scale convention is exercised
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if a.ndim <= 2 and a.shape[-1] in (cfg.d_model, cfg.head_dim) else a,
        jparams)
    return jcfg, cfg, jparams, to_torch(jparams, cfg)


def test_rms_norm_and_rope_spot_checks():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) + 7
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,blocks",
                         [(True, 0, (4, 3)), (True, 5, (8, 8)),
                          (False, 0, (3, 5))])
def test_blockwise_attention_matches_jax(causal, window, blocks):
    """Several ragged tiles, empty key slots (position -1), windows."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 11, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    qp = np.arange(11, dtype=np.int32) + 2
    kp = np.arange(13, dtype=np.int32)
    kp[[3, 7]] = -1
    kw = dict(causal=causal, window=window, q_block=blocks[0],
              k_block=blocks[1])
    ours = attention.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_positions=torch.from_numpy(qp), k_positions=torch.from_numpy(kp),
        **kw)
    theirs = jax_attention.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(qp),
        k_positions=jnp.asarray(kp), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)


def test_prefill_then_paged_decode_matches_jax(setup):
    jcfg, cfg, jparams, params = setup
    B, S, bs, nc = 3, 8, 8, 2
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    jmodel, model = JaxModel(jcfg), Model(cfg)
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                      S)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(), S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(caches[0].numpy(),
                               np.asarray(jcaches["stack"]["pos0"].k), **TOL)

    # row b owns blocks 2+2b (prompt) and 3+2b (decode column)
    n_blocks = 2 + B * nc
    table = (2 + np.arange(B * nc, dtype=np.int32)).reshape(B, nc)
    rows, cols, bids = list(range(B)), [0] * B, list(table[:, 0])
    jpools = jax_scatter(jax_init_pools(jmodel, n_blocks, bs), jcaches, rows,
                         cols, bids, block_size=bs)
    pools = init_paged_pools(model, n_blocks, bs, "cpu")
    scatter_prefill_blocks(pools, caches, rows, cols, bids, block_size=bs)

    tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    for step in range(6):
        pos = S + step
        jl, jpools = jmodel.decode_step_paged(
            jparams, jnp.asarray(tok), jpools, jnp.asarray(table),
            jnp.int32(pos))
        out = model.decode_step_paged(params, torch.from_numpy(tok).long(),
                                      pools, torch.from_numpy(table), pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None].astype(
            np.int32)
    np.testing.assert_allclose(pools.k.numpy(),
                               np.asarray(jpools["stack"]["pos0"].k), **TOL)
    np.testing.assert_allclose(pools.v.numpy(),
                               np.asarray(jpools["stack"]["pos0"].v), **TOL)
