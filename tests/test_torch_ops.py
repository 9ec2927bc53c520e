"""The port's elementwise device ops against the JAX functions.

Every input is made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU. Tolerances: rtol 1e-6 with an atol of 1e-6 for
values that are differences of O(1) terms (where a relative bound means
nothing near zero); integer results must be bit-equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import camera as jcam  # noqa: E402
from rayzath_tpu.ops import intersect as jint  # noqa: E402
from rayzath_tpu.ops import sort_rays as jsort  # noqa: E402
from rayzath_tpu.ops import tonemap as jtm  # noqa: E402
from rayzath_tpu.ops import vec as jvec  # noqa: E402
from rayzath_tpu.engine import state as jstate  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import camera as tcam  # noqa: E402
from rayzath_tpu_torch.ops import intersect as tint  # noqa: E402
from rayzath_tpu_torch.ops import sort_rays as tsort  # noqa: E402
from rayzath_tpu_torch.ops import tonemap as ttm  # noqa: E402
from rayzath_tpu_torch.ops import vec as tvec  # noqa: E402
from rayzath_tpu_torch.engine import state as tstate  # noqa: E402
from rayzath_tpu_torch.utils.check_keys import KEY_KINDS, key_rays  # noqa: E402

N = 512


def _close(a, b, rtol=1e-6, atol=1e-6):
    a = [a] if isinstance(a, torch.Tensor) else a
    b = [b] if not isinstance(b, (tuple, list)) else b
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_allclose(x.astype(np.float64),
                                   np.asarray(y, np.float64), rtol=rtol, atol=atol)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _u(rng, n=N):
    return rng.uniform(0.0, 1.0, n).astype(np.float32)


VEC_CASES = {
    "dot": lambda a, b, u1, u2: ((a, b), "dot"),
    "cross": lambda a, b, u1, u2: ((a, b), "cross"),
    "normalize": lambda a, b, u1, u2: ((a * 3.7,), "normalize"),
    "reflect": lambda a, b, u1, u2: ((a, b), "reflect"),
    "halfway": lambda a, b, u1, u2: ((a, b), "halfway"),
    "cosine_sample_hemisphere": lambda a, b, u1, u2: ((u1, u2, a),
                                                      "cosine_sample_hemisphere"),
    "sample_sphere": lambda a, b, u1, u2: ((u1, u2, a), "sample_sphere"),
    "sample_hemisphere": lambda a, b, u1, u2: ((u1, u2, a), "sample_hemisphere"),
    "sample_disk": lambda a, b, u1, u2: ((u1, u2, a, u1 + 0.1), "sample_disk"),
}


@pytest.mark.parametrize("name", sorted(VEC_CASES))
def test_vec_matches(name):
    rng = np.random.default_rng(sorted(VEC_CASES).index(name))
    args, fn = VEC_CASES[name](_unit(rng), _unit(rng), _u(rng), _u(rng))
    ours = getattr(tvec, fn)(*map(torch.as_tensor, args))
    ref = getattr(jvec, fn)(*map(jnp.asarray, args))
    _close(ours, ref)


def test_local_frame_matches():
    rng = np.random.default_rng(11)
    n = _unit(rng)
    _close(tvec.local_frame(torch.as_tensor(n)), jvec.local_frame(jnp.asarray(n)))


def test_fresnel_matches():
    rng = np.random.default_rng(12)
    vn, vi = _unit(rng), _unit(rng)
    n1 = rng.choice([1.0, 1.33, 1.5], N).astype(np.float32)
    n2 = rng.choice([1.0, 1.45, 2.4], N).astype(np.float32)
    ours = tvec.fresnel_specular_ratio(*map(torch.as_tensor, (vn, vi, n1, n2)))
    ref = jvec.fresnel_specular_ratio(*map(jnp.asarray, (vn, vi, n1, n2)))
    _close(ours, ref)
    assert tvec.TIR_TAU == jvec.TIR_TAU


def _cameras(w, h):
    world_j = rz.scenes.glass_and_fog(w, h)
    world_t = rt.scenes.glass_and_fog(w, h)
    return (tds.compile_camera(world_t.cameras[0], device="cpu"),
            jds.compile_camera(world_j.cameras[0]))


@pytest.mark.parametrize("row0", [0, 7])
def test_pixel_grid_matches(row0):
    ours = tcam.pixel_grid(24, 9, row0)
    ref = jcam.pixel_grid(24, 9, row0)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def test_generate_rays_matches():
    tc, jc = _cameras(32, 24)
    rng = np.random.default_rng(13)
    pix = tcam.pixel_grid(32, 24)
    u = rng.uniform(0, 1, (32 * 24, 4)).astype(np.float32)
    ours = tcam.generate_rays(tc, pix, torch.as_tensor(u))
    ref = jcam.generate_rays(jc, jnp.asarray(pix.numpy()), jnp.asarray(u))
    _close(ours, ref)


def test_simple_ray_and_sky_match():
    tc, jc = _cameras(32, 24)
    pix = tcam.pixel_grid(32, 24)
    ours = tcam.simple_ray(tc, pix)
    ref = jcam.simple_ray(jc, jnp.asarray(pix.numpy()))
    _close(ours, ref)
    _close(tcam.sky_texcrd(ours[1]), jcam.sky_texcrd(ref[1]))


@pytest.mark.parametrize("operator", ["hyper", "aces"])
def test_tonemap_matches(operator):
    rng = np.random.default_rng(14)
    acc = rng.uniform(0, 5, (8, 6, 4)).astype(np.float32)
    acc[..., 3] = rng.integers(0, 4, (8, 6))
    ours = ttm.final_color(torch.as_tensor(acc), torch.tensor(0.02),
                           torch.tensor(1.0 / 60), operator)
    ref = jtm.final_color(jnp.asarray(acc), jnp.float32(0.02),
                          jnp.float32(1.0 / 60), operator)
    _close(ours, ref)
    assert np.array_equal(ttm.to_u8(ours).numpy(), np.asarray(jtm.to_u8(ref)))


def test_refine_tri_matches():
    rng = np.random.default_rng(15)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = _unit(rng)
    v0 = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    ours = tint.refine_tri(*map(torch.as_tensor, (o, d, v0, e1, e2)))
    ref = jint.refine_tri(*map(jnp.asarray, (o, d, v0, e1, e2)))
    # XLA on the CPU contracts a*b + c into one FMA, torch rounds the product
    # and the sum apart, and the quotient by det amplifies that rounding by
    # the problem's condition. So rtol 1e-6 holds relative to the
    # condition-scaled magnitude of each output (the sum of the magnitudes
    # of the products it is made of, over |det|), not to the bare value.
    n = np.linalg.norm
    pvec = np.cross(d, e2)
    tvec = o - v0
    qvec = np.cross(tvec, e1)
    det = np.abs(np.sum(e1 * pvec, -1)) + 1e-30
    rest = n(e1, axis=1) * n(pvec, axis=1) / det
    t, b1, b2 = (np.abs(np.asarray(x)) for x in ref[:3])
    scales = (n(e2, axis=1) * n(qvec, axis=1) / det + t * rest,
              n(tvec, axis=1) * n(pvec, axis=1) / det + b1 * rest,
              n(d, axis=1) * n(qvec, axis=1) / det + b2 * rest,
              det * rest)
    for x, y, s in zip(ours, ref, scales):
        err = np.abs(x.numpy().astype(np.float64) - np.asarray(y))
        assert (err <= 1e-6 * s).all(), (err / s).max()


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_coherence_keys_bit_equal(kind):
    """The plain key (the CPU path, and the reference of the CUDA kernels)
    against the JAX package's, also on ties of the dominant lane, signed
    zeros and zero directions."""
    o, d = key_rays(kind, N, seed=16)
    ours = tsort.coherence_keys(torch.as_tensor(o), torch.as_tensor(d))
    ref = np.asarray(jsort.coherence_keys(jnp.asarray(o), jnp.asarray(d)))
    assert np.array_equal(ours.numpy(), ref.astype(np.int64))


def test_coherence_keys_take_the_plain_path_on_the_cpu():
    """CPU tensors take coherence_keys_plain and launch nothing; a tensor
    on another device than the CPU launches the kernels or raises (here:
    no card, no nvcc)."""
    o, d = (torch.as_tensor(x) for x in key_rays("bounce", 7, seed=3))
    before = tsort.coherence_keys.launches
    keys = tsort.coherence_keys(o, d)
    assert torch.equal(keys, tsort.coherence_keys_plain(o, d))
    assert keys.dtype == torch.int64
    assert tsort.coherence_keys.launches == before
    with pytest.raises(ValueError if torch.cuda.is_available() else RuntimeError):
        tsort.coherence_keys(o.to("meta"), d.to("meta"))


def test_sort_unsort_identity():
    rng = np.random.default_rng(17)
    o = torch.as_tensor(rng.uniform(-5, 5, (N, 3)).astype(np.float32))
    d = torch.as_tensor(_unit(rng))
    near = torch.as_tensor(_u(rng))
    ids = torch.arange(N, dtype=torch.int32)
    o_s, d_s, (near_s, ids_s), idx = tsort.sort_payload(o, d, (near, ids))
    keys = tsort.coherence_keys(o_s, d_s)
    assert bool((keys[1:] >= keys[:-1]).all())
    assert torch.equal(o_s, o[ids_s.long()])
    back = tsort.unsort_payload(idx, (o_s, d_s, near_s, ids_s))
    for x, y in zip(back, (o, d, near, ids)):
        assert torch.equal(x, y)


def test_init_state_matches():
    ours = tstate.init_state(12, 8, device="cpu")
    ref = jstate.init_state(12, 8)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
            assert a.numpy().dtype == np.asarray(b).dtype, f.name
        else:
            assert a == int(b), f.name


def test_state_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(18)
    st = tstate.init_state(6, 4, device="cpu")
    st = st.replace(accum=torch.as_tensor(rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)),
                    path_depth=torch.as_tensor(rng.integers(0, 9, 24).astype(np.int32)),
                    pass_idx=5)
    p = str(tmp_path / "ck.npz")
    tstate.save_state(p, st)
    back = tstate.load_state(p, device="cpu")
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
