"""The port's row gather (``rayzath_tpu_torch/ops/gather.py``) on the CPU.

``gather_rows`` is the counterpart of the JAX package's
``rayzath_tpu.ops.gather.gather_rows``; on the CPU it runs the plain
versions of its kernels, G1 (``table[idx]``) and G2 (the cotangent's rows
summed per index, in float64 rounded once). Held here, on tables and
indices made from numpy seeds:

* the forward bit for bit against the JAX ``gather_rows``: float32 tables
  of N <= 128 rows (its one-hot product, three bf16 limbs that sum back to
  the f32 value exactly for normal values) and of N > 128 (its plain take),
  an int32 table, idx of shape [R] and [R, 4] (the JAX function takes [R]:
  it gets the flattened [R, 4]), 1-D and 2-D tables, and R = 0;
* the backward against ``jax.vjp`` of a plain take ``table[idx]``, to 1e-6
  of max |g|, and against ``jax.vjp`` of the JAX ``gather_rows``, within
  the bf16 rounding of its transpose (2^-8 of max |g|; ROADMAP C);
* an out-of-range index clamped into the table as ``jnp.take(...,
  mode="clip")`` clamps it (and as JAX's ``table[idx]`` does above N);
* one CPU step on textured_room and on a two-level instanced_field(n=3)
  at 16^2 (depth 3, 4 passes): the loss bit
  for bit and every DIFF_PARAMS gradient to 1e-6 of its max |g| through
  ``gather_rows`` and through the ``table[idx]`` it replaced, and the
  backward running no accumulating ``index_put_``: no differentiable
  gather takes torch's index backward.

The kernels themselves run on the card: ``tests/test_torch_gpu.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(2)

from rayzath_tpu.ops.gather import ONE_HOT_MAX  # noqa: E402
from rayzath_tpu.ops.gather import gather_rows as jax_gather_rows  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models.device_scene import (compile_camera,  # noqa: E402
                                                   compile_world)
from rayzath_tpu_torch.ops import gather, texture  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as tc  # noqa: E402
from rayzath_tpu_torch.parallel import train  # noqa: E402

RTOL = 1e-6


def table_of(rng, n, row, dtype=np.float32):
    shape = (n,) + tuple(row)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return rng.uniform(-10.0, 10.0, size=shape).astype(np.float32)


def port(table, idx):
    return gather.gather_rows(torch.as_tensor(table), torch.as_tensor(idx)).numpy()


def jax_rows(table, idx):
    """The JAX gather_rows on any idx shape (it takes [R]: the rest is
    flattened and put back)."""
    flat = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx.reshape(-1)))
    return np.asarray(flat).reshape(idx.shape + table.shape[1:])


@pytest.mark.parametrize("n,row,dtype,idx_shape", [
    (8, (14,), np.float32, (257,)),          # the material table: one-hot
    (ONE_HOT_MAX, (4,), np.float32, (300, 4)),
    (3, (), np.float32, (64,)),              # a light's emission: 1-D table
    (8192, (4,), np.float32, (200, 4)),      # an atlas: the plain take
    (12288, (), np.float32, (100, 4)),
    (64 * 5, (), np.int32, (100,)),          # a flattened slot map (ints)
    (40, (), np.int32, (50, 4)),
    (8, (14,), np.float32, (0,)),            # no rays
    (300, (3,), np.float32, (0, 4)),
    (200, (32,), np.float32, (301,)),        # tri_pack's width: the plain take
    (20, (5,), np.float32, (77, 4)),         # an odd width: one-hot
])
def test_forward_bit_for_bit_as_jax(n, row, dtype, idx_shape):
    rng = np.random.default_rng(n + len(idx_shape))
    table = table_of(rng, n, row, dtype)
    idx = rng.integers(0, n, size=idx_shape).astype(np.int32)
    got = port(table, idx)
    ref = jax_rows(table, idx)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(got, table[idx])
    # int64 indices give the same rows
    assert np.array_equal(port(table, idx.astype(np.int64)), got)


def test_clamping_as_jax_take():
    """Indices below 0 and at or past N read the first and last rows, as
    jnp.take(mode="clip") reads them; at or past N also as JAX's own
    table[idx]. (The one-hot gather_rows gives zeros there; every caller
    clips first.)"""
    rng = np.random.default_rng(5)
    for n, row in ((8, (14,)), (200, (4,)), (5, ())):
        table = table_of(rng, n, row)
        idx = np.array([0, n - 1, n, n + 7, 10 ** 6, -1, -n - 3], np.int32)
        got = port(table, idx)
        clip = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0,
                                   mode="clip"))
        assert np.array_equal(got, clip)
        high = idx >= 0
        assert np.array_equal(got[high], np.asarray(jnp.asarray(table)[idx[high]]))
        # the backward sends each clamped index's cotangent to the row read
        g = rng.normal(size=idx.shape + row).astype(np.float32)
        d = gather.gather_rows_grad(torch.as_tensor(idx), torch.as_tensor(g), n)
        _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0,
                                            mode="clip"), jnp.asarray(table))
        ref = np.asarray(vjp(jnp.asarray(g))[0]).reshape(n, -1)
        assert np.abs(d.numpy() - ref).max() <= RTOL * np.abs(ref).max()


def port_grad(table, idx, g):
    t = torch.as_tensor(table).requires_grad_(True)
    out = gather.gather_rows(t, torch.as_tensor(idx))
    (d,) = torch.autograd.grad(out, t, torch.as_tensor(g))
    return d.numpy()


GRAD_CASES = [
    (8, (14,), (2000,)),                     # many rays on few rows
    (ONE_HOT_MAX, (4,), (500, 4)),
    (2, (), (1000,)),
    (8192, (4,), (3000, 4)),                 # an atlas
    (12288, (), (3000, 4)),
    (8, (14,), (0,)),
    (3, (3,), (1999,)),                      # a light's colour
    (200, (32,), (1000,)),                   # tri_pack's width
    (20, (5,), (333, 4)),                    # an odd width
]


@pytest.mark.parametrize("n,row,idx_shape", GRAD_CASES)
def test_backward_against_plain_take(n, row, idx_shape):
    rng = np.random.default_rng(100 + n)
    table = table_of(rng, n, row)
    idx = rng.integers(0, n, size=idx_shape).astype(np.int32)
    g = rng.normal(size=idx_shape + row).astype(np.float32)
    got = port_grad(table, idx, g)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    assert got.shape == table.shape and got.dtype == np.float32
    scale = np.abs(ref).max() if ref.size else 0.0
    assert np.abs(got - ref).max(initial=0.0) <= RTOL * scale
    if not idx.size:
        assert not got.any()


@pytest.mark.parametrize("n,row,idx_shape", GRAD_CASES[:4])
def test_backward_against_jax_gather_rows(n, row, idx_shape):
    """Within the bf16 rounding of the one-hot product's transpose (its
    cotangents are rounded to bf16, up to 2^-9 each), exact up to the order
    of the sums past ONE_HOT_MAX rows (a plain take)."""
    rng = np.random.default_rng(200 + n)
    table = table_of(rng, n, row)
    idx = rng.integers(0, n, size=idx_shape).astype(np.int32)
    g = rng.normal(size=idx_shape + row).astype(np.float32)
    got = port_grad(table, idx, g)
    flat = jnp.asarray(idx.reshape(-1))
    _, vjp = jax.vjp(lambda t: jax_gather_rows(t, flat), jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g.reshape((-1,) + row)))[0])
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= (2.0 ** -8 if n <= ONE_HOT_MAX else RTOL), err


def test_plain_grad_is_the_rounded_exact_sum():
    """gather_rows_grad_plain sums in float64: the float32 of the exact sum,
    whatever the order of the rows."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, size=5000).astype(np.int64)
    g = rng.uniform(0.0, 1.0, size=(5000, 3)).astype(np.float32)
    exact = np.zeros((4, 3))
    np.add.at(exact, idx, g.astype(np.float64))
    perm = rng.permutation(5000)
    a = gather.gather_rows_grad_plain(torch.as_tensor(idx), torch.as_tensor(g), 4)
    b = gather.gather_rows_grad_plain(torch.as_tensor(idx[perm]),
                                      torch.as_tensor(g[perm]), 4)
    assert np.array_equal(a.numpy(), exact.astype(np.float32))
    assert torch.equal(a, b)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors never launch (the counters stay), int tables carry no
    autograd node, a float table that needs a gradient does."""
    before = (gather.gather_rows_fwd.launches, gather.gather_rows_grad.launches)
    t = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    out = gather.gather_rows(t, torch.tensor([1, 1, 5], dtype=torch.int32))
    assert out.grad_fn is not None
    out.sum().backward()
    assert t.grad.tolist() == [[0, 0], [2, 2], [0, 0], [0, 0], [0, 0], [1, 1]]
    ints = gather.gather_rows(torch.arange(6, dtype=torch.int32),
                              torch.tensor([2, 3]))
    assert ints.dtype == torch.int32 and ints.tolist() == [2, 3]
    with torch.no_grad():
        assert gather.gather_rows(t, torch.tensor([0])).grad_fn is None
    assert (gather.gather_rows_fwd.launches,
            gather.gather_rows_grad.launches) == before
    # a tensor off the CPU launches or raises (here: no card, no nvcc)
    with pytest.raises(ValueError if torch.cuda.is_available() else RuntimeError):
        gather.gather_rows_fwd(torch.zeros(3, device="meta"),
                               torch.zeros(2, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# the training step through gather_rows and through table[idx]
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def index_gathers():
    """Every module that gathers through ``gather_rows`` takes the
    ``table[idx]`` that it replaced instead (torch's index backward)."""
    modules = (integrator, texture, tc)
    saved = [m.gather_rows for m in modules]
    for m in modules:
        m.gather_rows = lambda table, idx: table[idx.long()]
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.gather_rows = f


def step_grads(two_level, res=16, passes=4):
    if two_level:
        world = rt.scenes.instanced_field(res, res, n=3, resolution=12)
    else:
        world = rt.scenes.textured_room(res, res)
    scene = compile_world(world, two_level=two_level, differentiable=two_level,
                          device="cpu")
    cam = compile_camera(world.cameras[0], "cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3),
                          two_level=two_level)
    target = torch.full((res, res, 3), 0.2)
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in train.DIFF_PARAMS}
    with torch.enable_grad():
        loss, _ = train.image_loss(dataclasses.replace(scene, **leaves), cam, cfg,
                                   init_state(res, res, "cpu"), 11, target,
                                   passes)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
    ops = {e.name for e in prof.events()}
    return loss.detach(), dict(zip(leaves, grads)), ops


@pytest.mark.parametrize("two_level", [False, True])
def test_training_step_same_through_gather_rows_as_index(two_level):
    loss, grads, ops = step_grads(two_level)
    with index_gathers():
        loss_i, grads_i, ops_i = step_grads(two_level)
    assert torch.equal(loss, loss_i)
    # torch's index backward is an accumulating index_put_
    assert "aten::_index_put_impl_" in ops_i
    assert "aten::_index_put_impl_" not in ops and "aten::index_add_" in ops
    top = max(float(g.abs().max()) for g in grads_i.values() if g is not None)
    moved = 0
    for k in train.DIFF_PARAMS:
        a, b = grads[k], grads_i[k]
        assert (a is None) == (b is None), k
        if a is None:
            continue
        scale = max(float(b.abs().max()), 1e-4 * top)
        assert float((a - b).abs().max()) <= RTOL * scale, k
        moved += float(b.abs().max()) > 0.0
    assert moved >= (1 if two_level else 5)
