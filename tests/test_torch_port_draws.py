"""The distribution of every training draw, JAX package against the port.

The step tests inject the draws, so they hold the step bodies and not how
each package draws. Here each draw is made a few thousand times at fixed
seeds in both packages (the JAX draw through the JAX function itself where
it has one), and the two samples are compared:

- both inside the draw's support, where it has one;
- means within 4 standard errors of their difference;
- the two-sample Kolmogorov-Smirnov statistic under its 0.1% critical
  value, 1.949 * sqrt((n + m) / (n * m)).

Draws: the augmentation parameters of ``augment_batch`` (flip, angle,
scale, noise variance, noise switch, the noise), the dropout keep
fractions (``ChannelDropout`` and the HRNet's final dropout), the loader's
epoch order (equal, not only alike), the diffusion training time under
each time sampler and its noise, the SSN's low-rank normal draws, the
prob-U-Net's latents, and the ``lecun_normal`` initializer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from diffuncertainty_tpu.data import augment as j_augment
from diffuncertainty_tpu.data.loader import BatchLoader as JLoader
from diffuncertainty_tpu.models import diffusion as j_diffusion
from diffuncertainty_tpu.models import prob_unet as j_prob_unet
from diffuncertainty_tpu.models import ssn as j_ssn
from diffuncertainty_tpu.models.unet import ChannelDropout as JChannelDropout
from diffuncertainty_tpu_torch.data import augment as t_augment
from diffuncertainty_tpu_torch.data.loader import BatchLoader as TLoader
from diffuncertainty_tpu_torch.models import diffusion as t_diffusion
from diffuncertainty_tpu_torch.models import prob_unet as t_prob_unet
from diffuncertainty_tpu_torch.models import ssn as t_ssn
from diffuncertainty_tpu_torch.models.hrnet import HRNet, HRNetSpec
from diffuncertainty_tpu_torch.models.unet import ChannelDropout as TChannelDropout
from diffuncertainty_tpu_torch.models.unet import lecun_normal_
from torch_threads import one_torch_thread  # noqa: F401

N = 4096


def ks_limit(n: int, m: int) -> float:
    return 1.949 * np.sqrt((n + m) / (n * m))


def assert_same_distribution(name, a, b, lo=None, hi=None):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if lo is not None:
        assert a.min() >= lo and b.min() >= lo, (name, a.min(), b.min())
    if hi is not None:
        assert a.max() <= hi and b.max() <= hi, (name, a.max(), b.max())
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= 4 * se + 1e-12, (name, a.mean(), b.mean(), se)
    ks = stats.ks_2samp(a, b).statistic
    assert ks <= ks_limit(a.size, b.size), (name, ks, ks_limit(a.size, b.size))


class _RecordingRandom:
    """``jax.random`` whose bernoulli, uniform and normal draws are logged."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        fn = getattr(jax.random, name)
        if name not in ("bernoulli", "uniform", "normal"):
            return fn

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._log.append((name, np.asarray(out)))
            return out

        return recorded


class _RecordingJax:
    def __init__(self, log):
        self.random = _RecordingRandom(log)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(scope="module")
def augment_draws():
    """{draw: (JAX sample, port sample)} of one batch of N 4x4 images."""
    log = []
    mp = pytest.MonkeyPatch()
    mp.setattr(j_augment, "jax", _RecordingJax(log))
    try:
        images = jnp.zeros((N, 4, 4, 3), jnp.float32)
        masks = jnp.zeros((N, 4, 4), jnp.int32)
        j_augment.augment_batch(j_augment.TrainAugmentConfig(), jax.random.key(0), images, masks)
    finally:
        mp.undo()
    assert [k for k, _ in log] == ["bernoulli", "uniform", "uniform", "uniform", "bernoulli",
                                   "normal"]
    flip, angle, scale, var, apply_noise, noise = (v for _, v in log)
    d = t_augment.draw_augment(t_augment.TrainAugmentConfig().effective,
                               torch.Generator().manual_seed(0), torch.zeros(N, 4, 4, 3))
    return {"flip": (flip, d.flip.numpy()), "angle": (angle, d.angle.numpy()),
            "scale": (1.0 + scale, d.scale.numpy()), "noise_var": (var, d.noise_var.numpy()),
            "apply_noise": (apply_noise, d.apply_noise.numpy()),
            "noise": (noise[:, 0, 0], d.noise[:, 0, 0].numpy())}


@pytest.mark.parametrize("draw, lo, hi", [
    ("flip", 0, 1), ("angle", -22.5, 22.5), ("scale", 0.8, 1.2), ("noise_var", 0.2, 0.44),
    ("apply_noise", 0, 1), ("noise", None, None)])
def test_augment_batch_draws_match_jax(augment_draws, draw, lo, hi):
    j, t = augment_draws[draw]
    assert j.shape == t.shape
    assert_same_distribution(draw, j, t, lo, hi)
    if draw in ("flip", "apply_noise"):  # p = 0.5 both
        assert abs(t.mean() - 0.5) <= 4 * np.sqrt(0.25 / t.size)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_channel_dropout_keep_fractions_match_jax(rate):
    c = 64
    x = jnp.ones((N, 1, 1, c), jnp.float32)
    out = JChannelDropout(rate).apply({}, x, rngs={"dropout": jax.random.key(1)})
    j_keep = np.asarray(out[:, 0, 0] != 0)
    t_keep = TChannelDropout(rate).draw_mask((N, c), torch.Generator().manual_seed(1),
                                            torch.device("cpu")).numpy()
    assert t_keep.shape == j_keep.shape and t_keep.dtype == np.bool_
    assert_same_distribution("keep", j_keep, t_keep, 0, 1)
    assert_same_distribution("keep per row", j_keep.mean(1), t_keep.mean(1), 0, 1)
    assert abs(t_keep.mean() - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / t_keep.size)


def test_hrnet_final_dropout_keep_fraction_matches_jax():
    """The JAX HRNet's elementwise ``bernoulli(key, 1 - final_dropout,
    shape)`` of each branch (``models/hrnet.py``) against the port's
    ``HRNet.draw_keep``."""
    spec = HRNetSpec(width=8, stage1_channels=8, num_modules=(1, 1, 1), num_blocks=1,
                     final_dropout=0.3)
    shape = (N // 16, 4, 4, 8)  # NHWC
    j_keep = np.asarray(jax.random.bernoulli(jax.random.key(2), 1 - spec.final_dropout, shape))
    t_keep = HRNet(2, spec).draw_keep(0, shape, torch.Generator().manual_seed(2),
                                      torch.device("cpu")).numpy()
    assert t_keep.shape == j_keep.shape
    assert_same_distribution("final keep", j_keep, t_keep, 0, 1)
    assert_same_distribution("final keep per row", j_keep.reshape(shape[0], -1).mean(1),
                             t_keep.reshape(shape[0], -1).mean(1), 0, 1)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load(self, i, rng=None):
        return {"image": np.full((2, 2, 3), float(i), np.float32),
                "seg": np.zeros((2, 2), np.int32), "image_id": str(i), "dataset": "d"}


@pytest.mark.parametrize("seed", [0, 1, 2024])
def test_loader_epoch_order_equals_jax(seed):
    j = JLoader(_Indices(96), 8, shuffle=True, seed=seed, drop_last=True, use_native=False)
    t = TLoader(_Indices(96), 8, shuffle=True, seed=seed, drop_last=True)
    orders = []
    for epoch in range(40):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        np.testing.assert_array_equal(t._order(), j._order())
        orders.append(t._order())
    assert len({o.tobytes() for o in orders}) == 40  # a new order every epoch
    j.set_epoch(3)
    t.set_epoch(3)
    for jb, tb in zip(j, t):  # the batches in that order
        np.testing.assert_array_equal(tb["image"], jb["image"])


@pytest.mark.parametrize("sampler_type", ["uniform", "low_discrepency", "uniform_low_d"])
def test_diffusion_training_times_match_jax(sampler_type):
    bs = 8  # the 64-px study's batch: the stratification is per batch
    j_diff = j_diffusion.ContinuousGaussianDiffusion(sampler_type=sampler_type)
    t_diff = t_diffusion.ContinuousGaussianDiffusion(sampler_type=sampler_type)
    keys = jax.random.split(jax.random.key(3), N // bs)
    j_t = np.stack([np.asarray(j_diff.sample_t(k, bs)) for k in keys])
    g = torch.Generator().manual_seed(3)
    t_t = torch.stack([t_diffusion.draw_t(t_diff, bs, g) for _ in range(N // bs)]).numpy()
    assert_same_distribution("t", j_t, t_t, 0, 1)
    if sampler_type != "uniform":  # one time in each 1/bs stratum of every batch
        for t in (j_t, t_t):
            np.testing.assert_array_equal(np.sort(np.floor(t * bs), axis=1),
                                          np.tile(np.arange(bs), (N // bs, 1)))
    # the permutation: each stratum equally often at each row
    assert_same_distribution("stratum of row 0", np.floor(j_t[:, 0] * bs),
                             np.floor(t_t[:, 0] * bs), 0, bs - 1)


def test_diffusion_training_noise_matches_jax():
    shape = (N // 16, 4, 4, 2)
    k_t, k_eps = jax.random.split(jax.random.key(4))  # as train_loss_step splits
    j_eps = np.asarray(jax.random.normal(k_eps, shape, jnp.float32))
    t_eps = t_diffusion.draw_eps(shape, torch.Generator().manual_seed(4), torch.float32).numpy()
    assert_same_distribution("eps", j_eps, t_eps)
    assert abs(t_eps.std() - 1) <= 0.02


def test_ssn_draws_match_jax():
    rng = np.random.default_rng(5)
    b, n, r = 2, 6, 3
    mean = rng.standard_normal((b, n)).astype(np.float32)
    diag = rng.uniform(0.2, 1.5, (b, n)).astype(np.float32)
    factor = rng.standard_normal((b, n, r)).astype(np.float32)
    failed = np.zeros(b, bool)
    j = np.asarray(j_ssn.sample_n(j_ssn.SSNDistribution(*map(jnp.asarray, (mean, diag, factor,
                                                                           failed))),
                                  jax.random.key(5), N))
    t = t_ssn.sample_n(t_ssn.SSNDistribution(*map(torch.from_numpy, (mean, diag, factor,
                                                                     failed))),
                       torch.Generator().manual_seed(5), N).numpy()
    assert j.shape == t.shape == (N, b, n)
    cov = factor @ factor.transpose(0, 2, 1) + np.stack([np.diag(d) for d in diag])
    for i in range(b):
        for k in range(n):
            assert_same_distribution(f"ssn[{i}, {k}]", j[:, i, k], t[:, i, k])
        for s in (j, t):  # both to the analytic covariance
            np.testing.assert_allclose(np.cov(s[:, i].T), cov[i], atol=0.15 * np.abs(cov[i]).max())


def test_prob_unet_latents_match_jax():
    rng = np.random.default_rng(6)
    mu = np.tile(rng.standard_normal((1, 6)).astype(np.float32), (N, 1))
    log_sigma = np.tile(rng.uniform(-1.0, 0.5, (1, 6)).astype(np.float32), (N, 1))
    j = np.asarray(j_prob_unet.sample_latent(
        j_prob_unet.LatentParams(jnp.asarray(mu), jnp.asarray(log_sigma)), jax.random.key(6)))
    t = t_prob_unet.sample_latent(t_prob_unet.LatentParams(torch.from_numpy(mu),
                                                           torch.from_numpy(log_sigma)),
                                  torch.Generator().manual_seed(6)).numpy()
    for k in range(6):
        assert_same_distribution(f"z[{k}]", j[:, k], t[:, k])
        np.testing.assert_allclose(t[:, k].std(), np.exp(log_sigma[0, k]), rtol=0.05)


@pytest.mark.parametrize("fan_in", [27, 576])
def test_lecun_normal_init_matches_flax(fan_in):
    """The conv kernels' init: flax's truncated ``lecun_normal`` against the
    port's ``lecun_normal_``, beyond their stds (the cut at 2 std)."""
    shape = (N // 4, fan_in)
    j = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(7), (fan_in, N // 4)))
    w = torch.empty(shape)
    lecun_normal_(w, fan_in, torch.Generator().manual_seed(7))
    std = 1 / np.sqrt(fan_in) / 0.87962566103423978
    assert_same_distribution("kernel", j[:, :512], w.numpy()[:512], -2 * std, 2 * std)
