"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device; only launch/dryrun.py forces 512 host devices (and the
distributed integration tests spawn subprocesses with their own flags)."""
import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_reduced_config


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def make_batch(cfg, B=2, S=16, seed=0):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 3)
    if cfg.frontend == "audio_frames":
        return {
            "frames": jax.random.normal(ks[0], (B, S, cfg.d_model),
                                        jnp.float32),
            "labels": jax.random.randint(ks[1], (B, S), 0, cfg.vocab_size),
            "mask": jax.random.uniform(ks[2], (B, S)) < 0.4,
        }
    batch = {"tokens": jax.random.randint(ks[0], (B, S), 0, cfg.vocab_size)}
    if cfg.frontend == "vision_patches":
        F = min(cfg.frontend_seq, S // 2)
        batch["patch_embeds"] = jax.random.normal(
            ks[1], (B, F, cfg.d_model), jnp.float32)
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips elsewhere "
        "(on a machine with the card and without jax: PYTHONPATH=src python "
        "-m pytest --noconftest -m cuda tests/test_torch_gpu.py)")
