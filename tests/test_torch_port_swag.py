"""Port parity of the SWAG posterior, the SWAG-diag member draw and the
member-stack weight bridge, against the JAX package on the same numpy inputs.

The parameter tree is small and random (a conv, a dense layer and a norm);
the state is built by ``collect`` from 5 snapshots with ``max_num_models`` 4,
so the deviation ring wraps. The draws are JAX's own: the normals that
``jax.random`` gives for a pinned key are handed, in the port's order, to
``models/swag.py::draw_normal``. Float32, held to atol 1e-6 with rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.models import swag as j_swag
from diffuncertainty_tpu.tools.bench_weights import save_params_npz
from diffuncertainty_tpu.tools.train_bench_assets import swag_draw_members as j_swag_draw_members
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.core.params import (flax_to_torch, flax_to_torch_stacked,
                                                   load_member_stack, load_swag_npz,
                                                   stack_states)
from diffuncertainty_tpu_torch.models import swag as t_swag
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.tools.bench_assets import swag_draw_members

TOL = dict(atol=1e-6, rtol=1e-5)
SWAG_ASSET = "assets/bench_unet16_toy128_swag.npz"
K = 4  # max_num_models: 5 snapshots wrap the ring
SHAPES = {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)},
          "block": {"dense": {"kernel": (4, 5), "bias": (5,)},
                    "norm": {"scale": (4,), "bias": (4,)}}}


def random_tree(rng, shapes=SHAPES, scale=1.0):
    return {k: random_tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32) for k, v in shapes.items()}


def port_key(path) -> str:
    """The port's state-dict key of a JAX leaf path (``core/params.py``)."""
    *mod, leaf = [p.key for p in path]
    return ".".join(mod + ["weight" if leaf in ("kernel", "scale") else "bias"])


def snapshots(n=5, seed=0):
    rng = np.random.default_rng(seed)
    base = random_tree(rng)
    return [jax.tree.map(lambda b: b + 0.1 * rng.standard_normal(b.shape).astype(np.float32),
                         base) for _ in range(n)]


def both_states(diag_only: bool):
    snaps = snapshots()
    js = j_swag.init(jax.tree.map(jnp.asarray, snaps[0]), K, diag_only=diag_only)
    ts = t_swag.init(flax_to_torch(snaps[0]), K, diag_only=diag_only)
    for s in snaps:
        js = j_swag.collect(js, jax.tree.map(jnp.asarray, s), K)
        ts = t_swag.collect(ts, flax_to_torch(s), K)
    return js, ts


def jax_sample_normals(state, key, blockwise: bool, use_low_rank: bool, order: list):
    """The normals JAX ``swag.sample(state, key)`` draws, in the port's draw
    order: z (one, or one per leaf in the port's key ``order``), then eps per
    leaf in that order, eps in the port's layout."""
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(state.mean)
    n = len(paths_leaves)
    k_diag, k_rank = jax.random.split(key)
    eps = [np.asarray(jax.random.normal(k, leaf.shape, leaf.dtype))
           for k, (_, leaf) in zip(jax.random.split(k_diag, n), paths_leaves)]
    eps_port = flax_to_torch(jax.tree.unflatten(treedef, eps))
    zs = []
    if use_low_rank:
        if blockwise:
            z_by_key = {port_key(p): np.asarray(jax.random.normal(k, (K,)))
                        for k, (p, _) in zip(jax.random.split(k_rank, n), paths_leaves)}
            zs = [z_by_key[k] for k in order]
        else:
            zs = [np.asarray(jax.random.normal(k_rank, (K,)))]
    return [torch.from_numpy(z) for z in zs] + [eps_port[k] for k in order]


def inject(monkeypatch, normals):
    queue, shapes = list(normals), []

    def draw(shape, generator, dtype):
        shapes.append(tuple(shape))
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape) and dtype == torch.float32
        return out

    monkeypatch.setattr(t_swag, "draw_normal", draw)
    return queue, shapes


@pytest.mark.parametrize("diag_only", [False, True])
def test_init_and_collect_match_jax_when_the_ring_wraps(diag_only):
    js, ts = both_states(diag_only)
    assert ts.n_models == int(js.n_models) == 5
    for name in ("mean", "sq_mean"):
        ref = flax_to_torch(jax.tree.map(np.asarray, getattr(js, name)))
        got = getattr(ts, name)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)
    if diag_only:
        assert ts.dev is None and js.dev is None
        return
    ref = flax_to_torch_stacked(jax.tree.map(np.asarray, js.dev))
    for k in ref:
        assert ts.dev[k].shape[0] == K
        np.testing.assert_allclose(ts.dev[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)
    # the fifth snapshot overwrote slot 0 against the new mean
    snap = flax_to_torch(snapshots()[4])
    for k in ref:
        torch.testing.assert_close(ts.dev[k][0], snap[k] - ts.mean[k], atol=0, rtol=0)


def test_collect_leaves_the_old_state_as_it_was():
    _, ts = both_states(False)
    before = {k: v.clone() for k, v in ts.dev.items()}
    t_swag.collect(ts, flax_to_torch(snapshots(1, seed=5)[0]), K)
    for k in before:
        torch.testing.assert_close(ts.dev[k], before[k], atol=0, rtol=0)


CASES = {"diag": dict(use_low_rank=False, blockwise=False, scale=1.0),
         "low_rank": dict(use_low_rank=True, blockwise=False, scale=1.0),
         "blockwise": dict(use_low_rank=True, blockwise=True, scale=0.5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_matches_jax_with_the_jax_normals(monkeypatch, case):
    kw = CASES[case]
    js, ts = both_states(diag_only=False)
    key = jax.random.key(3)
    ref = flax_to_torch(jax.tree.map(np.asarray, j_swag.sample(js, key, max_num_models=K, **kw)))
    normals = jax_sample_normals(js, key, kw["blockwise"], kw["use_low_rank"], list(ts.mean))
    queue, shapes = inject(monkeypatch, normals)
    got = t_swag.sample(ts, torch.Generator(), max_num_models=K, **kw)
    assert not queue
    n_z = (len(ref) if kw["blockwise"] else 1) if kw["use_low_rank"] else 0
    assert shapes[:n_z] == [(K,)] * n_z
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)
        assert not torch.equal(got[k], ts.mean[k])


def test_low_rank_rows_past_the_collected_count_are_masked(monkeypatch):
    """Two snapshots in a ring of 4: only rows 0 and 1 of z may act."""
    snaps = snapshots(2)
    ts = t_swag.init(flax_to_torch(snaps[0]), K)
    for s in snaps:
        ts = t_swag.collect(ts, flax_to_torch(s), K)
    zero_var = t_swag.SwagState(ts.n_models, ts.mean,
                                {k: m * m for k, m in ts.mean.items()}, ts.dev)
    keys = list(ts.mean)
    z = torch.tensor([0.0, 0.0, 5.0, -3.0])
    inject(monkeypatch, [z] + [torch.zeros_like(ts.mean[k]) for k in keys])
    got = t_swag.sample(zero_var, torch.Generator(), max_num_models=K, var_clamp=0.0)
    for k in keys:
        torch.testing.assert_close(got[k], ts.mean[k], atol=0, rtol=0)


def test_sample_members_matches_jax(monkeypatch):
    js, ts = both_states(diag_only=False)
    key, m = jax.random.key(8), 3
    kw = dict(max_num_models=K, scale=1.0)
    ref = flax_to_torch_stacked(jax.tree.map(
        np.asarray, j_swag.sample_members(js, key, m, **kw)))
    normals = [n for k in jax.random.split(key, m)
               for n in jax_sample_normals(js, k, blockwise=False, use_low_rank=True,
                                          order=list(ts.mean))]
    queue, _ = inject(monkeypatch, normals)
    got = t_swag.sample_members(ts, torch.Generator(), m, **kw)
    assert not queue
    for k in ref:
        assert got[k].shape[0] == m
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)
    assert not torch.equal(got["conv.weight"][0], got["conv.weight"][1])


def test_diag_sampling_of_a_diag_only_state_and_its_refusal_of_low_rank():
    _, ts = both_states(diag_only=True)
    t_swag.sample(ts, torch.Generator().manual_seed(0), max_num_models=K, use_low_rank=False)
    with pytest.raises(ValueError, match="diag_only"):
        t_swag.sample(ts, torch.Generator(), max_num_models=K)


def test_swag_draw_members_matches_jax_with_the_jax_normals(monkeypatch):
    rng = np.random.default_rng(4)
    mean = random_tree(rng)
    std = jax.tree.map(lambda a: np.abs(a).astype(np.float16), random_tree(rng, scale=0.1))
    key, m, scale = jax.random.key(42), 3, 0.7
    ref = flax_to_torch_stacked(jax.tree.map(np.asarray, j_swag_draw_members(
        {"mean": mean, "std": std}, key, m, scale=scale)))
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(mean)
    normals = []
    for mk in jax.random.split(key, m):
        eps = [np.asarray(jax.random.normal(k, leaf.shape, jnp.float32))
               for k, (_, leaf) in zip(jax.random.split(mk, len(paths_leaves)), paths_leaves)]
        eps_port = flax_to_torch(jax.tree.unflatten(treedef, eps))
        normals += [eps_port[k] for k in flax_to_torch(mean)]
    queue, _ = inject(monkeypatch, normals)
    got = swag_draw_members(flax_to_torch(mean), flax_to_torch(std), torch.Generator(), m,
                            scale=scale)
    assert not queue
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].shape[0] == m
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL, err_msg=k)


def test_swag_draw_members_draws_each_member_afresh():
    rng = np.random.default_rng(5)
    mean = flax_to_torch(random_tree(rng))
    std = {k: torch.full_like(v, 0.5) for k, v in mean.items()}
    a = swag_draw_members(mean, std, torch.Generator().manual_seed(42), 4)
    b = swag_draw_members(mean, std, torch.Generator().manual_seed(42), 4)
    for k in mean:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
        assert len({a[k][i].sum().item() for i in range(4)}) == 4  # every member differs
        assert a[k].device == torch.device("cpu")


def test_stacked_bridge_equals_the_bridge_of_each_member_slice():
    rng = np.random.default_rng(6)
    stack = random_tree(rng, jax.tree.map(lambda s: (3,) + s, SHAPES,
                                          is_leaf=lambda x: isinstance(x, tuple)))
    got = flax_to_torch_stacked({"params": stack})
    for m in range(3):
        one = flax_to_torch(jax.tree.map(lambda a: a[m], stack))
        assert list(got) == list(one)
        for k in one:
            torch.testing.assert_close(got[k][m], one[k], atol=0, rtol=0)
    assert got["conv.weight"].shape == (3, 4, 2, 3, 3)
    assert got["block.dense.weight"].shape == (3, 5, 4)
    ragged = dict(stack, conv={"kernel": stack["conv"]["kernel"][:2], "bias": stack["conv"]["bias"]})
    with pytest.raises(ValueError, match="member count"):
        flax_to_torch_stacked(ragged)


def test_stack_states_checks_every_key_and_shape():
    rng = np.random.default_rng(7)
    a, b = flax_to_torch(random_tree(rng)), flax_to_torch(random_tree(rng))
    stack = stack_states([a, b])
    torch.testing.assert_close(stack["conv.weight"][1], b["conv.weight"], atol=0, rtol=0)
    with pytest.raises(KeyError, match="member 1"):
        stack_states([a, {k: v for k, v in b.items() if k != "conv.bias"}])
    with pytest.raises(KeyError, match="member 1"):
        stack_states([a, dict(b, **{"conv.bias": torch.zeros(5)})])


def test_load_member_stack_maps_every_checkpoint_onto_the_module(tmp_path):
    built = build_model(load_config(eu_method="ensemble"), device="cpu")
    own = built.module.state_dict()
    rng = np.random.default_rng(8)
    paths = []
    for m in range(2):
        tree = {}
        for key, v in own.items():  # the flax tree of the port's keys
            *mod, name = key.split(".")
            leaf = {"weight": "kernel" if v.ndim in (2, 4) else "scale", "bias": "bias"}[name]
            shape = tuple(v.shape)
            shape = (shape[2], shape[3], shape[1], shape[0]) if v.ndim == 4 else (
                shape[::-1] if v.ndim == 2 else shape)
            node = tree
            for p in mod:
                node = node.setdefault(p, {})
            node[leaf] = rng.standard_normal(shape).astype(np.float32)
        paths.append(save_params_npz({"params": tree}, tmp_path / f"member{m}.npz"))
    stack = load_member_stack(paths, built.module)
    assert set(stack) == set(own)
    for k, v in own.items():
        assert stack[k].shape == (2,) + tuple(v.shape)
    assert not torch.equal(stack["input_conv.weight"][0], stack["input_conv.weight"][1])
    with pytest.raises(KeyError):
        small = build_model(load_config(model="ssn", eu_method="none"), device="cpu")
        load_member_stack(paths, small.module)


def test_swag_asset_reader_keeps_meta_out_and_widens_std_exactly():
    moments = load_swag_npz(SWAG_ASSET)
    assert (moments.n_snapshots, moments.max_snapshots) == (30, 30)
    built = build_model(load_config(eu_method="swag_diag"), device="cpu")
    own = built.module.state_dict()
    assert set(moments.mean) == set(moments.std) == set(own)
    assert not any("meta" in k for k in moments.mean)
    raw = np.load(SWAG_ASSET)
    kernel = raw["std/params/input_conv/kernel"]
    assert kernel.dtype == np.float16
    np.testing.assert_array_equal(moments.std["input_conv.weight"].numpy(),
                                  kernel.astype(np.float32).transpose(3, 2, 0, 1))
    for k, v in moments.std.items():
        assert v.dtype == torch.float32 and v.shape == own[k].shape
        assert moments.mean[k].dtype == torch.float32
    assert min(v.min().item() for v in moments.std.values()) >= 0.0
