"""A CPU model of the ranked front-to-back walk of the closest-hit kernels
B1 (``csrc/cluster_closest.cu``) and B3 (``csrc/cluster_closest_inst.cu``),
held to their plain versions bit for bit, and of the shadow kernels B2
(``csrc/cluster_shadow.cu``) and B4 (``csrc/cluster_shadow_inst.cu``), held
to theirs under the renderer's forward gate.

The CUDA kernels cannot run here, so this file models their block walk in
torch, step for step, on blocks of 128 rays: the rank (each row's lower
bound of the entry distance by interval arithmetic on the block's origin
and direction bounds), the sort by (bound, row), the walk in
batches of 32 with the block's stop vote, the per-ray gate at every visit,
the windows of table rows, and the tie key that makes the result
independent of the walk's order. The model's ids and t must equal
``cluster_closest_plain`` / ``cluster_closest_inst_plain`` bit for bit on
mesh_heavy-like and instanced_field-like rays, on tables whose duplicated
triangles tie exactly across cluster rows and instance rows with the later
row entered first, and with a window small enough that the walk takes
three or more windows. The kernels themselves meet the same tables on the
card in tests/test_torch_gpu.py.

B3 and B4 walk per warp below the block's instance rank (the warp walk):
the block ranks the instance rows, then each warp of 32 rays walks that
list alone, a candidate at a time under its own stop, and ranks a visited
mesh's clusters BATCH at a time by the bounds of its own rays. The model
does the same, on meshes of one to several windows of BATCH clusters.

The shadow model walks the same way with a product in place of the
minimum: a ray is live while its alpha is at least ALPHA_STOP, its reach
is its dist while live and -1 once blocked (so it votes no more and marks
no candidate), the rank's cap is the block's largest live dist, each
visited cluster's factors enter as one product per cluster (the plain
versions' structure), and the walk stops when no live ray reaches the next
batch. It must meet ``cluster_shadow_plain`` / ``cluster_shadow_inst_plain``
to rtol 1e-5 / atol 1e-6 where the plain alpha is at least 1e-4, and both
be below 1e-4 elsewhere: the rank changes only the order of the factors.

The backward model (B2-grad ``csrc/cluster_shadow_grad.cu``, B4-grad
``csrc/cluster_shadow_inst_grad.cu``) walks the same way twice with no
alpha stop: walk 1 keeps each ray's product of non-zero factors and its
zero count, walk 2 (only the rays with a non-zero coefficient) visits the
same clusters and sums each visit's shares over the block's rays into an
accumulator that is then added to the gradient table (per cluster visit
for B2-grad, per instance visit for B4-grad). It must give
``cluster_shadow_grad_plain`` / ``cluster_shadow_inst_grad_plain`` to rtol
1e-5 of their max |g| (the sums' order differs), testing every needed
cluster in walk 1.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import camera as cam_ops  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as tc  # noqa: E402
from rayzath_tpu_torch.ops._kernels import header_constant  # noqa: E402
from rayzath_tpu_torch.utils import check_tables as ct  # noqa: E402
from test_torch_gpu import half_translucent, shadow_gate  # noqa: E402

THREADS = header_constant("THREADS")        # rays per block
BATCH = header_constant("BATCH")            # candidates per block vote
SWEEP_MAX = header_constant("SWEEP_MAX")    # B3: smaller meshes are swept
GATE_PAD = np.float32(header_constant("GATE_PAD"))
BIG = np.float32(header_constant("BIG"))
ALPHA_STOP = header_constant("ALPHA_STOP")  # B2/B4: a ray below it is blocked
GROUP = header_constant("GROUP")            # B1/B2: cluster rows per group row


def safe_inv(v):
    s = torch.where(v.abs() < 1e-12,
                    torch.where(v < 0, torch.full_like(v, -1e-12),
                                torch.full_like(v, 1e-12)), v)
    return 1.0 / s


def gate_t(best_t):
    return best_t + GATE_PAD * best_t.abs()


def slab(lo, hi, o, inv, pad=False):
    """(tmin, tmax) [B] of rays (o, inv) [B, 3] against one box, as the
    kernels' ``slab`` (or ``slab_wide`` with ``pad``) computes them."""
    lo, hi = lo[None], hi[None]
    if pad:
        p = GATE_PAD * (lo.abs() + hi.abs())
        lo, hi = lo - p, hi + p
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    return (torch.minimum(t1, t2).amax(1), torch.maximum(t1, t2).amin(1))


class Block:
    """The per-ray state of one block: best t, tie key and ids."""

    def __init__(self, near, far):
        self.near = near
        self.active = far > 0
        self.best_t = torch.where(self.active, torch.clamp(far, max=BIG),
                                  torch.full_like(far, -1.0))
        self.best_key = torch.zeros(len(far), dtype=torch.int64)
        self.best_id = torch.full((len(far),), -1, dtype=torch.int32)
        self.best_inst = torch.full((len(far),), -1, dtype=torch.int32)
        self.tests = torch.zeros(len(far), dtype=torch.int32)

    def gate(self, tmin, tmax, rays):
        return (rays & (tmax >= self.near) & (tmin <= tmax)
                & (tmin <= gate_t(self.best_t)))

    def take(self, t, b1, b2, rays, key0, base, gid=-1):
        """Hits of one cluster's 128 slots for the rays ``rays``: nearest
        first, the lowest slot on a tie inside the cluster, and across rows
        the smaller key on an exact tie with the best so far."""
        lanes = torch.arange(t.shape[1])
        ok = tc._inside(b1, b2) & (t > self.near[:, None]) & rays[:, None]
        tm = torch.where(ok, t, torch.full_like(t, float("inf")))
        t_new = tm.amin(1)
        j = torch.where(tm == t_new[:, None], lanes, t.shape[1]).amin(1)
        key = key0 + j
        got = (ok.any(1) & ((t_new < self.best_t)
                            | ((t_new == self.best_t) & (key < self.best_key))))
        self.best_t = torch.where(got, t_new, self.best_t)
        self.best_key = torch.where(got, key, self.best_key)
        self.best_id = torch.where(got, (base + j).to(torch.int32), self.best_id)
        self.best_inst = torch.where(got, torch.full_like(self.best_inst, gid),
                                     self.best_inst)
        self.tests += rays.to(torch.int32)


F32 = torch.float32
ROUND = 1.0 / 1048576.0


def bounds(o, d, rays, near, best_t):
    """The block's rays as boxes (``block_bounds``): origin and direction
    bounds of the rays ``rays``, their smallest near and cap = gate_t of
    their largest best_t; None when no ray is active."""
    if not bool(rays.any()):
        return None
    return (o[rays].amin(0), o[rays].amax(0), d[rays].amin(0),
            d[rays].amax(0), near[rays].min(), gate_t(best_t[rays].max()))


def entry_bound(b, lo, hi):
    """``entry_bound``: a lower bound of the entry distance t >= 0 of the
    block's rays into the box lo..hi widened by GATE_PAD, rounded down by
    2^-20; inf when no ray can enter it by the cap; -inf for every box when
    a ray's near is negative (the bound covers t >= 0 only, so the block
    walks in table order). f32 throughout."""
    olo, ohi, dlo, dhi, nlo, cap = b
    if nlo < 0:
        return -float("inf")
    tl, th = torch.zeros((), dtype=F32), torch.tensor(float("inf"))
    one = torch.ones((), dtype=F32)
    for a in range(3):
        pad = GATE_PAD * (lo[a].abs() + hi[a].abs())
        vl, vh = (lo[a] - pad) - ohi[a], (hi[a] + pad) - olo[a]
        dl, dh = dlo[a], dhi[a]
        if dl > 0:
            lv, hv = vl / dh, vh / dl
        elif dh < 0:
            lv, hv = vh / dl, vl / dh
        else:
            lv = (vl / torch.clamp(dh, min=1e-30) if vl > 0 else
                  vh / torch.clamp(dl, max=-1e-30) if vh < 0 else 0 * one)
            empty = (vl > 0 and dh <= 0) or (vh < 0 and dl >= 0)
            hv = -one if empty else torch.tensor(float("inf"))
        tl, th = torch.maximum(tl, lv), torch.minimum(th, hv)
    tl = tl * (1.0 - ROUND)
    th = th * (1.0 + ROUND) if th > 0 else th
    return float(tl) if (tl <= th and tl <= cap) else float("inf")


def rank(rows, row_box, b):
    """Sorted (bound, row) of the feasible rows: ``rank_window``."""
    if b is None:
        return []
    out = []
    for row in rows:
        lo, hi = row_box(row)
        pd = entry_bound(b, lo, hi)
        if pd != float("inf"):
            out.append((pd, row))
    return sorted(out)


def walk(cands, reach, rays, need, visit):
    """Walk ranked candidates in batches of BATCH: stop when no ray's
    (current) gate, gate_t(reach()), reaches the batch's first entry; visit
    every candidate some ray of the block needs, in order. Returns the
    visits."""
    visits = 0
    for k0 in range(0, len(cands), BATCH):
        batch = cands[k0:k0 + BATCH]
        go = rays & (torch.tensor(batch[0][0], dtype=torch.float32)
                     <= gate_t(reach()))
        if not bool(go.any()):
            break
        todo = [row for _, row in batch if bool((go & need(row)).any())]
        for row in todo:
            visit(row)
            visits += 1
    return visits


def warp_walk(cands, reach, rays, need, visit):
    """``warp_walk`` (B3/B4): the ranked candidates one at a time for the
    rays ``rays`` of one warp: stop when none of them reaches the
    candidate's entry (gate_t(reach())), visit it when one of them needs
    it. Returns the visits."""
    visits = 0
    for pd, row in cands:
        if not bool((rays & (torch.tensor(pd, dtype=torch.float32)
                             <= gate_t(reach()))).any()):
            break
        if bool((rays & need(row)).any()):
            visit(row)
            visits += 1
    return visits


def warp_lanes(n):
    """The masks of a block's warps of 32 rays (of ``n``)."""
    for w0 in range(0, n, 32):
        lanes = torch.zeros(n, dtype=torch.bool)
        lanes[w0:w0 + 32] = True
        yield lanes


def walk_grouped(groups, gate, b, reach, active, need, visit):
    """``walk_grouped`` (B1, B2 on a table above the line): the real group
    rows ranked by the block's bounds ``b`` and walked under the block
    vote, a ray marking the groups whose box passes ``gate(lo, hi,
    rays)``; each group entered has its real rows (the first count of its
    rows) swept in table order as one batch (entry -inf: no stop), the rays
    that need the group (at the visit) voting on each row. Returns
    (cluster visits, groups entered)."""
    glo, ghi = groups[0:3].t(), groups[3:6].t()
    visits = [0]

    def gneed(g):
        return gate(glo[g], ghi[g], active)

    def visit_group(g):
        first, count = int(groups[tc.B_BASE, g]), int(groups[tc.B_CNT, g])
        sweep = [(-float("inf"), c) for c in range(first, first + count)]
        visits[0] += walk(sweep, reach, gneed(g), need, visit)

    real = [g for g in range(groups.shape[1]) if groups[tc.B_CNT, g] > 0]
    entered = walk(rank(real, lambda g: (glo[g], ghi[g]), b), reach, active,
                   gneed, visit_group)
    return visits[0], entered


def model_closest(o, d, near, far, box_tab, frames, window=ct.RANK_WINDOW,
                  groups=None, entered=None):
    """B1's walk, block by block: flat, or through the group table
    ``groups`` (then ``entered``, a list, receives each block's groups
    entered). Returns (t, cluster-order id, block visits, cluster tests per
    ray)."""
    cp = box_tab.shape[1]
    lo, hi = box_tab[0:3].t(), box_tab[3:6].t()
    cnt = box_tab[tc.B_CNT]
    t_out, id_out, tests, visits = [], [], [], 0
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = Block(near[sl], far[sl])

        def need(c):
            return blk.gate(*slab(lo[c], hi[c], ob, inv), blk.active)

        def visit(c):
            t, b1, b2 = tc._project(ob, db, box_tab, frames, c)
            blk.take(t, b1, b2, need(c), c * 128, int(box_tab[tc.B_BASE, c]))

        if bool(blk.active.any()) and groups is not None:
            v, g = walk_grouped(
                groups,
                lambda glo, ghi, rays: blk.gate(*slab(glo, ghi, ob, inv), rays),
                bounds(ob, db, blk.active, blk.near, blk.best_t),
                lambda: blk.best_t, blk.active, need, visit)
            visits += v
            entered.append(g)
        elif bool(blk.active.any()):
            for w0 in range(0, cp, window):
                rows = [c for c in range(w0, min(cp, w0 + window)) if cnt[c] > 0]
                b = bounds(ob, db, blk.active, blk.near, blk.best_t)
                visits += walk(rank(rows, lambda c: (lo[c], hi[c]), b),
                               lambda: blk.best_t, blk.active, need, visit)
        t_out.append(blk.best_t)
        id_out.append(blk.best_id)
        tests.append(blk.tests)
    return torch.cat(t_out), torch.cat(id_out), visits, torch.cat(tests)


def model_closest_inst(o, d, near, far, ti_rows, cl_obox, frames,
                       window=ct.RANK_WINDOW):
    """B3's walk, block by block: instances ranked by the block's rays in
    windows of ``window`` rows, then each warp of 32 rays walking the
    block's instance list alone (:func:`warp_walk`) and each visited mesh's
    clusters, ranked BATCH at a time by the bounds of its own rays (more
    than SWEEP_MAX) or swept. Returns (t, id, inst, visits)."""
    box = cl_obox.t().contiguous()
    t_out, id_out, inst_out, visits = [], [], [], 0
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = Block(near[sl], far[sl])
        n_visits = [0]

        def ineed(k):
            row = ti_rows[k]
            return blk.gate(*slab(row[0:3], row[3:6], ob, inv, pad=True),
                            blk.active)

        def visit_inst(k, lanes):
            row = ti_rows[k]
            in_k = ineed(k) & lanes
            oo, dd = tc._object_rays(ob, db, ti_rows, k)
            invl = safe_inv(dd)
            cl0, ncl, gid = (int(row[tc.TI_CL0]), int(row[tc.TI_NCL]),
                             int(row[tc.TI_ID]))

            def cneed(s):
                return blk.gate(*slab(cl_obox[s, 0:3], cl_obox[s, 3:6], oo,
                                      invl, pad=True), in_k)

            def cvisit(s):
                t, b1, b2 = tc._project(oo, dd, box, frames, s)
                blk.take(t, b1, b2, cneed(s), (k << 32) + s * 128,
                         int(cl_obox[s, tc.B_BASE]), gid)

            for s0 in range(cl0, cl0 + ncl, BATCH):
                rows = list(range(s0, min(cl0 + ncl, s0 + BATCH)))
                if ncl <= SWEEP_MAX:
                    cands = [(-float("inf"), s) for s in rows]
                else:
                    cands = rank(rows, lambda s: (cl_obox[s, 0:3],
                                                  cl_obox[s, 3:6]),
                                 bounds(oo, dd, in_k, blk.near, blk.best_t))
                n_visits[0] += warp_walk(cands, lambda: blk.best_t, in_k,
                                         cneed, cvisit)

        if bool(blk.active.any()):
            ip = ti_rows.shape[0]
            for w0 in range(0, ip, window):
                rows = [k for k in range(w0, min(ip, w0 + window))
                        if ti_rows[k, tc.TI_NCL] > 0]
                b = bounds(ob, db, blk.active, blk.near, blk.best_t)
                cands = rank(rows, lambda k: (ti_rows[k, 0:3],
                                              ti_rows[k, 3:6]), b)
                for lanes in warp_lanes(len(ob)):
                    warp_walk(cands, lambda: blk.best_t, blk.active & lanes,
                              ineed, lambda k: visit_inst(k, lanes))
        visits += n_visits[0]
        t_out.append(blk.best_t)
        id_out.append(blk.best_id)
        inst_out.append(blk.best_inst)
    return torch.cat(t_out), torch.cat(id_out), torch.cat(inst_out), visits


def _bounce(o, d, t, hit, seed):
    p = torch.where(hit[:, None], o + d * (t * 0.999)[:, None], o)
    v = np.random.default_rng(seed).normal(size=(len(o), 3)).astype(np.float32)
    return p.contiguous(), torch.as_tensor(v / np.linalg.norm(v, axis=1,
                                                              keepdims=True))


def scene_rays(scene, world, res, seed):
    """Camera rays (u = 0.5) and bounce-like rays from their first hits."""
    cam = tds.compile_camera(world.cameras[0], device="cpu")
    r = res * res
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res),
                                 torch.full((r, 4), 0.5))
    near, far = torch.zeros(r), torch.full((r,), 1e30)
    if scene.two_level:
        t = tc.cluster_closest_inst_plain(o, d, near, far, scene.ti_rows,
                                          scene.cl_obox, scene.cl_lw)[0]
    else:
        t = tc.cluster_closest_plain(o, d, near, far, scene.cl_box,
                                     scene.cl_lw)[0]
    return [(o, d), _bounce(o, d, t, (t > 0) & (t < 1e30), seed)], near, far


def assert_bits(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("window", [ct.RANK_WINDOW, 8])
def test_model_b1_matches_plain_on_mesh_heavy_like_rays(window):
    world = rt.scenes.mesh_heavy(24, 24, resolution=40)
    scene = tds.compile_world(world, device="cpu")
    real = int((scene.cl_box[tc.B_CNT] > 0).sum())
    assert real > 2 * 8, real             # window 8: three or more windows
    sets, near, far = scene_rays(scene, world, 24, seed=3)
    for o, d in sets:
        *got, visits, _ = model_closest(o, d, near, far, scene.cl_box,
                                        scene.cl_lw, window)
        assert_bits(got, tc.cluster_closest_plain(o, d, near, far,
                                                  scene.cl_box, scene.cl_lw))
        assert int((got[1] >= 0).sum()) > len(o) // 4
        assert 0 < visits < real * -(-len(o) // THREADS)   # the walk culls


@pytest.mark.parametrize("resolution", [8, 48, 60, 96])
def test_model_b3_matches_plain_on_instanced_field_like_rays(resolution):
    """resolution 8: one cluster per ball (swept); 48: 24 (ranked); 60: 40
    and 96: 104 (ranked and walked in windows of BATCH)."""
    world = rt.scenes.instanced_field(16, 16, n=3, resolution=resolution)
    scene = tds.compile_world(world, two_level=True, device="cpu")
    assert (scene.max_ncl > SWEEP_MAX) == (resolution > 8)
    assert (scene.max_ncl > BATCH) == (resolution > 48)
    sets, near, far = scene_rays(scene, world, 16, seed=4)
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw)
    for o, d in sets:
        *got, visits = model_closest_inst(o, d, near, far, *tabs)
        assert_bits(got, tc.cluster_closest_inst_plain(o, d, near, far, *tabs))
        assert int((got[1] >= 0).sum()) > len(o) // 4 and visits > 0


def _table_rays(tabs, r, seed):
    o, d = (torch.as_tensor(x) for x in ct.aimed_rays(tabs["v0"], tabs["e1"],
                                                       tabs["e2"], r, seed))
    return o, d, torch.zeros(r), torch.full((r,), 1e30)


@pytest.mark.parametrize("window", [ct.RANK_WINDOW, 8])
def test_model_b1_ties_across_rows(window):
    """Every hit ties exactly in rows c and c + m; the grown later row is
    entered first, and the earlier row must win, as in table order."""
    tabs = ct.tie_tables()
    box, frames = (torch.as_tensor(tabs[k]) for k in ("box_tab", "frames"))
    o, d, near, far = _table_rays(tabs, 384, seed=5)
    m = tabs["real_rows"] // 2
    if window == 8:
        assert 2 * m > 2 * 8              # three or more windows
    got_t, got_id, *_ = model_closest(o, d, near, far, box, frames, window)
    ref = tc.cluster_closest_plain(o, d, near, far, box, frames)
    assert_bits((got_t, got_id), ref)
    hit = ref[1] >= 0
    assert int(hit.sum()) > 150
    first = box[tc.B_BASE, m].item()      # copy B's ids start here
    assert bool((ref[1][hit] < first).all())          # copy A wins every tie
    # for a one-ray block copy B's entry bound is never the farther of the
    # two, and mostly the nearer: the walk meets copy B first
    one = torch.ones(1, dtype=torch.bool)
    pd = dict((c, e) for e, c in rank(
        range(2 * m), lambda c: (box[0:3, c], box[3:6, c]),
        bounds(o[:1], d[:1], one, near[:1], far[:1])))
    both = [c for c in range(m) if c in pd]
    assert all(pd[c + m] <= pd[c] for c in both)
    assert 2 * sum(pd[c + m] < pd[c] for c in both) > len(both) > 0


def test_model_b3_ties_across_instances_and_clusters():
    tabs = ct.tie_instance_tables()
    ti, obox, frames = (torch.as_tensor(tabs[k])
                        for k in ("ti_rows", "cl_obox", "frames"))
    o, d, near, far = _table_rays(tabs, 384, seed=6)
    got = model_closest_inst(o, d, near, far, ti, obox, frames)[:3]
    ref = tc.cluster_closest_inst_plain(o, d, near, far, ti, obox, frames)
    assert_bits(got, ref)
    hit = ref[1] >= 0
    assert int(hit.sum()) > 150
    assert bool((ref[2][hit] != 1).all())      # instance row 0 wins its ties


def test_model_b3_mesh_windows():
    """A mesh of more than three times BATCH clusters, which a warp ranks
    and walks in windows of BATCH: the result stays exact."""
    tabs = ct.window_instance_tables(rows=100, n=300, seed=9)
    ti, obox, frames = (torch.as_tensor(tabs[k])
                        for k in ("ti_rows", "cl_obox", "frames"))
    assert int(ti[:, tc.TI_NCL].max()) > 3 * BATCH
    o, d, near, far = _table_rays(tabs, 256, seed=7)
    got = model_closest_inst(o, d, near, far, ti, obox, frames)[:3]
    assert_bits(got, tc.cluster_closest_inst_plain(o, d, near, far, ti, obox,
                                                   frames))


def test_model_stops_early():
    """The stop vote ends a block's walk: rays that all hit a near wall
    along (1, 1, 1) test only the clusters they need, though their lines
    cross five times as many, and their blocks stage a fraction of the
    rows (tests/test_torch_gpu.py holds B1 to the same bar)."""
    tabs = ct.window_tables(rows=200, n=300, seed=8)
    box, frames = (torch.as_tensor(tabs[k]) for k in ("box_tab", "frames"))
    r = 512
    o, d = (torch.as_tensor(x) for x in ct.wall_rays(tabs["v0"], tabs["e1"],
                                                     tabs["e2"], r))
    near, far = torch.zeros(r), torch.full((r,), 1e30)
    got_t, got_id, visits, tests = model_closest(o, d, near, far, box, frames)
    ref = tc.cluster_closest_plain(o, d, near, far, box, frames)
    assert_bits((got_t, got_id), ref)
    needed = ct.needed_soup(o, d, near, ref[0], box)[0]
    on_line = ct.needed_soup(o, d, near, far, box)[0]
    assert on_line >= 3 * needed > 0, (on_line, needed)
    assert int(tests.sum()) <= 2 * needed, (int(tests.sum()), needed)
    assert visits < tabs["real_rows"] // 4 * (r // THREADS), visits


@pytest.mark.parametrize("kernel", ["b1", "b3"])
def test_model_matches_plain_with_negative_near(kernel):
    """near < 0 on every other ray (hits behind the origin count): the
    rank's bound covers t >= 0 only, so such blocks walk in table order,
    and the result stays the plain version's on the tie tables."""
    if kernel == "b1":
        tabs = ct.tie_tables()
        keys = ("box_tab", "frames")
    else:
        tabs = ct.tie_instance_tables()
        keys = ("ti_rows", "cl_obox", "frames")
    o, d, near, far = _table_rays(tabs, 256, seed=9)
    near[::2] = -3.0
    tabs_t = [torch.as_tensor(tabs[k]) for k in keys]
    if kernel == "b1":
        got = model_closest(o, d, near, far, *tabs_t)[:2]
        ref = tc.cluster_closest_plain(o, d, near, far, *tabs_t)
    else:
        got = model_closest_inst(o, d, near, far, *tabs_t)[:3]
        ref = tc.cluster_closest_inst_plain(o, d, near, far, *tabs_t)
    assert_bits(got, ref)
    assert bool((ref[0][(ref[1] >= 0)] < 0).any())     # a hit behind an origin


# ---------------------------------------------------------------------------
# the shadow walks (B2, B4)
# ---------------------------------------------------------------------------

class ShadowBlock:
    """The per-ray state of one block of a shadow walk: the rgba product
    and the cluster tests."""

    def __init__(self, dist):
        self.dist = dist
        self.active = dist > 0
        self.m = torch.ones((len(dist), 4))
        self.tests = torch.zeros(len(dist), dtype=torch.int32)
        self.fetches = torch.zeros(len(dist), dtype=torch.int64)

    def live(self):
        return self.active & (self.m[:, 3] >= ALPHA_STOP)

    def reach(self):
        return torch.where(self.live(), self.dist, torch.full_like(self.dist, -1.0))

    def gate(self, tmin, tmax, rays):
        """The exact (B2) or widened (B4) slab gate on (0, dist), for the
        rays ``rays`` that are still live."""
        return (rays & self.live() & (tmax >= 0) & (tmin <= tmax)
                & (tmin <= self.dist))

    def take(self, t, b1, b2, rays, op, cutouts=None, c=None):
        """One cluster's product for the rays ``rays``: op [4, 128] is the
        factor of each slot, taken where the slot is hit in (0, dist), times
        the texel factor of a hit in a cutout slot of row ``c`` (B2's cutout
        variant, ``cutouts`` a ``tc.Cutouts``), whose fetches it counts."""
        hit = tc._inside(b1, b2) & (t > 0.0) & (t < self.dist[:, None])
        fac = torch.where(hit[:, None, :], op[None], 1.0)
        tex = (None if cutouts is None else
               tc.cutout_factors(c, hit & rays[:, None], b1, b2, cutouts))
        if tex is not None:
            fac = fac * tex[0]
            self.fetches += tex[1]
        fac = fac.prod(dim=2)
        self.m = torch.where(rays[:, None], self.m * fac, self.m)
        self.tests += rays.to(torch.int32)


def model_shadow(o, d, dist, box_tab, frames, op_tab, window=ct.RANK_WINDOW,
                 groups=None, entered=None, cutouts=None, fetches=None):
    """B2's walk, block by block: flat, or through the group table
    ``groups`` (then ``entered``, a list, receives each block's groups
    entered); with ``cutouts``, its cutout variant (then ``fetches``, a
    list, receives each block's texel fetches per ray). Returns (rgb, a,
    block visits, cluster tests per ray)."""
    cp = box_tab.shape[1]
    lo, hi = box_tab[0:3].t(), box_tab[3:6].t()
    cnt = box_tab[tc.B_CNT]
    m_out, tests, visits = [], [], 0
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = ShadowBlock(dist[sl])
        zero = torch.zeros(len(ob))

        def need(c):
            return blk.gate(*slab(lo[c], hi[c], ob, inv), blk.active)

        def visit(c):
            t, b1, b2 = tc._project(ob, db, box_tab, frames, c)
            blk.take(t, b1, b2, need(c), op_tab[c], cutouts, c)

        if bool(blk.active.any()) and groups is not None:
            v, g = walk_grouped(
                groups,
                lambda glo, ghi, rays: blk.gate(*slab(glo, ghi, ob, inv), rays),
                bounds(ob, db, blk.live(), zero, blk.dist),
                blk.reach, blk.active, need, visit)
            visits += v
            entered.append(g)
        elif bool(blk.active.any()):
            for w0 in range(0, cp, window):
                rows = [c for c in range(w0, min(cp, w0 + window)) if cnt[c] > 0]
                b = bounds(ob, db, blk.live(), zero, blk.dist)
                visits += walk(rank(rows, lambda c: (lo[c], hi[c]), b),
                               blk.reach, blk.active, need, visit)
        m_out.append(blk.m)
        tests.append(blk.tests)
        if fetches is not None:
            fetches.append(blk.fetches)
    m = torch.cat(m_out)
    return m[:, 0:3], m[:, 3], visits, torch.cat(tests)


def model_shadow_inst(o, d, dist, ti_rows, cl_obox, frames, cl_slot, op_tab,
                      window=ct.RANK_WINDOW):
    """B4's walk, block by block, as :func:`model_closest_inst`'s, each
    hit's factor op_tab[gid, :, cl_slot[s, j]]. Returns (rgb, a, visits,
    cluster tests per ray)."""
    box = cl_obox.t().contiguous()
    slots = cl_slot.long()
    m_out, tests, visits = [], [], 0
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = ShadowBlock(dist[sl])
        zero = torch.zeros(len(ob))
        n_visits = [0]

        def ineed(k):
            row = ti_rows[k]
            return blk.gate(*slab(row[0:3], row[3:6], ob, inv, pad=True),
                            blk.active)

        def visit_inst(k, lanes):
            row = ti_rows[k]
            in_k = ineed(k) & lanes
            oo, dd = tc._object_rays(ob, db, ti_rows, k)
            invl = safe_inv(dd)
            cl0, ncl, gid = (int(row[tc.TI_CL0]), int(row[tc.TI_NCL]),
                             int(row[tc.TI_ID]))

            def cneed(s):
                return blk.gate(*slab(cl_obox[s, 0:3], cl_obox[s, 3:6], oo,
                                      invl, pad=True), in_k)

            def cvisit(s):
                t, b1, b2 = tc._project(oo, dd, box, frames, s)
                blk.take(t, b1, b2, cneed(s), op_tab[gid][:, slots[s]])

            for s0 in range(cl0, cl0 + ncl, BATCH):
                rows = list(range(s0, min(cl0 + ncl, s0 + BATCH)))
                if ncl <= SWEEP_MAX:
                    cands = [(-float("inf"), s) for s in rows]
                else:
                    cands = rank(rows, lambda s: (cl_obox[s, 0:3],
                                                  cl_obox[s, 3:6]),
                                 bounds(oo, dd, in_k & blk.live(), zero,
                                        blk.dist))
                n_visits[0] += warp_walk(cands, blk.reach, in_k, cneed,
                                         cvisit)

        if bool(blk.active.any()):
            ip = ti_rows.shape[0]
            for w0 in range(0, ip, window):
                rows = [k for k in range(w0, min(ip, w0 + window))
                        if ti_rows[k, tc.TI_NCL] > 0]
                b = bounds(ob, db, blk.live(), zero, blk.dist)
                cands = rank(rows, lambda k: (ti_rows[k, 0:3],
                                              ti_rows[k, 3:6]), b)
                for lanes in warp_lanes(len(ob)):
                    warp_walk(cands, blk.reach, blk.active & lanes, ineed,
                              lambda k: visit_inst(k, lanes))
        visits += n_visits[0]
        m_out.append(blk.m)
        tests.append(blk.tests)
    m = torch.cat(m_out)
    return m[:, 0:3], m[:, 3], visits, torch.cat(tests)


def _soup_op(scene, mat_color):
    mat = mat_color[scene.tri_mat.long()]
    return tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                              scene.cl_base, scene.cl_count)


def _dists(t, hit):
    """dist = the ray's first hit (else BIG), and dist = BIG."""
    big = torch.full_like(t, float(BIG))
    return {"hit": torch.where(hit, t, big), "big": big}


@pytest.mark.parametrize("alpha", ["opaque", "half"])
@pytest.mark.parametrize("dist", ["hit", "big"])
def test_model_b2_matches_plain_on_mesh_heavy_like_rays(dist, alpha):
    world = rt.scenes.mesh_heavy(24, 24, resolution=40)
    scene = tds.compile_world(world, device="cpu")
    mc = scene.mat_color if alpha == "opaque" else half_translucent(scene.mat_color)
    op_tab = _soup_op(scene, mc)
    sets, near, far = scene_rays(scene, world, 24, seed=3)
    partial = 0
    for o, d in sets:
        t, tid = tc.cluster_closest_plain(o, d, near, far, scene.cl_box,
                                          scene.cl_lw)
        dd = _dists(t, tid >= 0)[dist]
        ref = tc.cluster_shadow_plain(o, d, dd, scene.cl_box, scene.cl_lw, op_tab)
        *got, visits, tests = model_shadow(o, d, dd, scene.cl_box, scene.cl_lw,
                                           op_tab)
        shadow_gate(got, ref)
        partial += int(((ref[1] > 0) & (ref[1] < 1)).sum())
        blocked = int((ref[1] < ALPHA_STOP).sum())
        assert (blocked > len(o) // 8) == (dist == "big")
        assert visits > 0 and int(tests.sum()) > 0
    if dist == "big":           # dist = hit: nothing lies before the hit
        assert (partial > 20) == (alpha == "half"), partial


@pytest.mark.parametrize("alpha", ["opaque", "half"])
@pytest.mark.parametrize("resolution", [8, 48, 60, 96])
def test_model_b4_matches_plain_on_instanced_field_like_rays(resolution, alpha):
    """resolution 8: one cluster per ball (swept); 48: 24 (ranked); 60: 40
    and 96: 104 (ranked in windows of BATCH); each ray set at dist = hit
    and dist = BIG: each ray's thread takes its per-cluster products in its
    own walk order, within the forward gate of the plain version."""
    world = rt.scenes.instanced_field(16, 16, n=3, resolution=resolution)
    scene = tds.compile_world(world, two_level=True, device="cpu")
    assert (scene.max_ncl > SWEEP_MAX) == (resolution > 8)
    mc = scene.mat_color if alpha == "opaque" else half_translucent(scene.mat_color)
    op_tab = tc.instance_opacity(mc, scene.inst_slot_map)
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot, op_tab)
    sets, near, far = scene_rays(scene, world, 16, seed=4)
    partial = 0
    for o, d in sets:
        t, tid, _ = tc.cluster_closest_inst_plain(o, d, near, far, *tabs[:3])
        for dd in _dists(t, tid >= 0).values():
            ref = tc.cluster_shadow_inst_plain(o, d, dd, *tabs)
            *got, visits, tests = model_shadow_inst(o, d, dd, *tabs)
            shadow_gate(got, ref)
            partial += int(((ref[1] > 0) & (ref[1] < 1)).sum())
            assert visits > 0 and int(tests.sum()) > 0
    assert (partial > 20) == (alpha == "half"), partial


def _window_spans(o, d, dist, box_tab, frames, window):
    """Per ray, the number of windows of ``window`` rows that hold a hit in
    (0, dist) (the plain version's projection, cluster by cluster)."""
    spans = torch.zeros((len(o), -(-box_tab.shape[1] // window)), dtype=torch.bool)
    for c, _ in tc._real_clusters(box_tab):
        t, b1, b2 = tc._project(o, d, box_tab, frames, c)
        hit = (tc._inside(b1, b2) & (t > 0) & (t < dist[:, None])).any(1)
        spans[:, c // window] |= hit
    return spans.sum(1)


def _soup_tables(tabs, seed):
    box, frames, order = (torch.as_tensor(tabs[k])
                          for k in ("box_tab", "frames", "order"))
    op = {k: torch.as_tensor(v) for k, v in ct.soup_opacity(tabs, seed).items()}
    op_tab = tc.cluster_opacity(op["op_rgb"], op["op_a"], order, op["base"],
                                op["count"])
    return box, frames, op_tab


@pytest.mark.parametrize("window", [ct.RANK_WINDOW, 8])
def test_model_b2_translucent_window_table(window):
    """Translucent products over a tiled table: with 8-row windows a
    product spans three or more windows, and the rank, the vote and the
    alpha stop keep it the plain version's."""
    tabs = ct.window_tables(rows=300, n=2000, seed=8)
    box, frames, op_tab = _soup_tables(tabs, seed=10)
    o, d, *_ = _table_rays(tabs, 512, seed=11)
    dist = torch.full((len(o),), float(BIG))
    ref = tc.cluster_shadow_plain(o, d, dist, box, frames, op_tab)
    *got, visits, _ = model_shadow(o, d, dist, box, frames, op_tab, window)
    shadow_gate(got, ref)
    spans = _window_spans(o, d, dist, box, frames, 8)
    live = ref[1] >= ALPHA_STOP
    assert int((live & (spans >= 3)).sum()) > 10
    assert int(((ref[1] > ALPHA_STOP) & (ref[1] < 0.5)).sum()) > 10
    assert visits > 0


def test_model_b4_translucent_window_table():
    """Translucent products over one mesh of more clusters than three of a
    warp's windows of BATCH, under two instances: a product spans three or
    more windows (of either instance), and slot rows and instance opacity
    rows resolve every factor."""
    tabs = ct.window_instance_tables(rows=100, n=2000, seed=9)
    mats = {k: torch.as_tensor(v) for k, v in
            ct.instance_materials(tabs, seed=12).items()}
    ti, obox, frames = (torch.as_tensor(tabs[k])
                        for k in ("ti_rows", "cl_obox", "frames"))
    assert obox.shape[0] > 3 * BATCH > SWEEP_MAX
    op_tab = tc.instance_opacity(mats["mat_color"], mats["inst_slot_map"])
    o, d, *_ = _table_rays(tabs, 256, seed=13)
    dist = torch.full((len(o),), float(BIG))
    tabs_t = (ti, obox, frames, mats["cl_slot"], op_tab)
    ref = tc.cluster_shadow_inst_plain(o, d, dist, *tabs_t)
    got = model_shadow_inst(o, d, dist, *tabs_t)[:2]
    shadow_gate(got, ref)
    spans = sum(_window_spans(*tc._object_rays(o, d, ti, k), dist,
                              obox.t().contiguous(), frames, BATCH)
                for k in (0, 1))
    assert int(((ref[1] >= ALPHA_STOP) & (spans >= 3)).sum()) > 10
    assert int(((ref[1] > ALPHA_STOP) & (ref[1] < 0.5)).sum()) > 10


@pytest.mark.parametrize("kernel", ["b2", "b4"])
@pytest.mark.parametrize("case", ["instances", "clusters"])
def test_model_shadow_takes_every_factor_of_128_rows(case, kernel):
    """The 128-layer translucent stack (alpha 0.01 per layer): every factor
    is taken, alpha = 0.99^128 = 0.276252, through the soup walk (B2) and
    the two-level walk (B4), where the JAX ranked loops drop the last row
    (ROADMAP C)."""
    from test_torch_gpu import stack_rays, stacked_world
    from rayzath_tpu_torch.models.mesh import Mesh
    from rayzath_tpu_torch.utils.hostmath import Transform
    world = stacked_world(case, rt.World, Mesh, Transform)
    o, d, dist = (torch.as_tensor(x) for x in stack_rays(case))
    if kernel == "b2":
        scene = tds.compile_world(world, two_level=False, device="cpu")
        rgb, a, *_ = model_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                                  _soup_op(scene, scene.mat_color))
    else:
        scene = tds.compile_world(world, two_level=True, device="cpu")
        rgb, a, *_ = model_shadow_inst(
            o, d, dist, scene.ti_rows, scene.cl_obox, scene.cl_lw,
            scene.cl_slot, tc.instance_opacity(scene.mat_color,
                                               scene.inst_slot_map))
    np.testing.assert_allclose(a.numpy(), 0.99 ** 128, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("kernel", ["b2", "b4"])
def test_model_shadow_stops_at_the_opaque_wall(kernel):
    """Shadow rays with dist = BIG that hit an opaque wall along (1, 1, 1):
    their lines cross five times the clusters they need (those that meet
    (0, the wall's hit)), and the walk tests at most twice the needed ones,
    since front to back meets the wall first and the blocked rays vote no
    more (tests/test_torch_gpu.py holds B2 and B4 to the same bar)."""
    r = 512
    if kernel == "b2":
        tabs = ct.window_tables(rows=200, n=300, seed=8)
        box, frames, _ = _soup_tables(tabs, seed=14)
        op_tab = torch.zeros((box.shape[1], 4, tc.CLUSTER_T))     # opaque
    else:
        tabs = ct.window_instance_tables(rows=200, n=300, seed=9)
        mats = ct.instance_materials(tabs, seed=15, alpha=(1.0, 1.0))
        ti, obox, frames = (torch.as_tensor(tabs[k])
                            for k in ("ti_rows", "cl_obox", "frames"))
        slots = torch.as_tensor(mats["cl_slot"])
        op_tab = tc.instance_opacity(torch.as_tensor(mats["mat_color"]),
                                     torch.as_tensor(mats["inst_slot_map"]))
    o, d = (torch.as_tensor(x) for x in ct.wall_rays(tabs["v0"], tabs["e1"],
                                                     tabs["e2"], r))
    zero, far = torch.zeros(r), torch.full((r,), 1e30)
    dist = torch.full((r,), float(BIG))
    if kernel == "b2":
        t = tc.cluster_closest_plain(o, d, zero, far, box, frames)[0]
        ref = tc.cluster_shadow_plain(o, d, dist, box, frames, op_tab)
        *got, _, tests = model_shadow(o, d, dist, box, frames, op_tab)
        needed = ct.needed_soup(o, d, zero, t, box)[0]
        on_line = ct.needed_soup(o, d, zero, dist, box)[0]
    else:
        t = tc.cluster_closest_inst_plain(o, d, zero, far, ti, obox, frames)[0]
        ref = tc.cluster_shadow_inst_plain(o, d, dist, ti, obox, frames, slots,
                                           op_tab)
        *got, _, tests = model_shadow_inst(o, d, dist, ti, obox, frames, slots,
                                           op_tab)
        needed = ct.needed_inst(o, d, zero, t, ti, obox)[0]
        on_line = ct.needed_inst(o, d, zero, dist, ti, obox)[0]
    shadow_gate(got, ref)
    assert bool((ref[1] == 0).all())              # every ray meets the wall
    assert on_line >= 5 * needed > 0, (on_line, needed)
    assert int(tests.sum()) <= 2 * needed, (int(tests.sum()), needed)


# ---------------------------------------------------------------------------
# the shadow backwards' walks (B2-grad, B4-grad)
# ---------------------------------------------------------------------------

class GradBlock(ShadowBlock):
    """The per-ray state of one block of a shadow backward: no alpha stop (a
    ray with a non-zero cotangent walks while its dist reaches), walk 1's
    product of the non-zero factors P and zero count z per channel, walk
    2's coefficients (A, B), and the cluster tests of both walks."""

    def __init__(self, dist, g):
        super().__init__(dist)
        self.active = (dist > 0) & (g != 0).any(1)
        self.g = g
        self.P = torch.ones((len(dist), 4))
        self.z = torch.zeros((len(dist), 4), dtype=torch.int64)
        self.coef = None

    def live(self):
        return self.active

    def take(self, t, b1, b2, rays, op):
        """Walk 1 over one cluster for the rays ``rays``."""
        hit = (tc._inside(b1, b2) & (t > 0.0) & (t < self.dist[:, None])
               & rays[:, None])
        zero = op == 0.0
        f = torch.where(hit[:, None, :] & ~zero[None], op[None], 1.0)
        self.P = self.P * f.prod(dim=2)
        self.z = self.z + (hit[:, None, :] & zero[None]).sum(dim=2)
        self.tests += rays.to(torch.int32)

    def second_walk(self):
        """The coefficients of store_coef; the rays without one walk no
        more."""
        gp = self.g * self.P
        a = torch.where(self.z == 0, gp, torch.zeros(()))
        b = torch.where(self.z == 1, gp, torch.zeros(()))
        self.coef = (a, b)
        self.active = self.active & ((a != 0) | (b != 0)).any(1)

    def scatter(self, t, b1, b2, rays, op):
        """Walk 2 over one cluster: the block accumulator [4, ct] of the
        rays ``rays``' shares (scatter_test_ray)."""
        hit = (tc._inside(b1, b2) & (t > 0.0) & (t < self.dist[:, None])
               & rays[:, None])
        a, b = self.coef
        share = torch.where(op[None] != 0.0, a[:, :, None] / op[None],
                            b[:, :, None])
        self.tests += rays.to(torch.int32)
        return torch.where(hit[:, None, :], share, torch.zeros(())).sum(0)


def model_shadow_grad(o, d, dist, box_tab, frames, op_tab, g,
                      window=ct.RANK_WINDOW):
    """B2-grad's walks, block by block: B2's ranked walk twice without the
    stop, each visit of walk 2 adding its block accumulator to the table.
    Returns (d_op_tab, cluster tests per ray of walk 1, of walk 2)."""
    cp = box_tab.shape[1]
    lo, hi = box_tab[0:3].t(), box_tab[3:6].t()
    cnt = box_tab[tc.B_CNT]
    d_op = torch.zeros_like(op_tab)
    tests = ([], [])
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = GradBlock(dist[sl], g[sl])
        zero = torch.zeros(len(ob))

        def need(c):
            return blk.gate(*slab(lo[c], hi[c], ob, inv), blk.active)

        def visit1(c):
            blk.take(*tc._project(ob, db, box_tab, frames, c), need(c), op_tab[c])

        def visit2(c):
            d_op[c] += blk.scatter(*tc._project(ob, db, box_tab, frames, c),
                                   need(c), op_tab[c])

        for second, visit in ((False, visit1), (True, visit2)):
            if second:
                tests[0].append(blk.tests.clone())
                blk.tests.zero_()
                blk.second_walk()
            if not bool(blk.active.any()):
                continue
            for w0 in range(0, cp, window):
                rows = [c for c in range(w0, min(cp, w0 + window)) if cnt[c] > 0]
                b = bounds(ob, db, blk.live(), zero, blk.dist)
                walk(rank(rows, lambda c: (lo[c], hi[c]), b), blk.reach,
                     blk.active, need, visit)
        tests[1].append(blk.tests)
    return d_op, torch.cat(tests[0]), torch.cat(tests[1])


def model_shadow_inst_grad(o, d, dist, ti_rows, cl_obox, frames, cl_slot,
                           op_tab, g, window=ct.RANK_WINDOW,
                           mesh_window=ct.MESH_WINDOW):
    """B4-grad's walks, block by block: B4's two-level walk twice without
    the stop, each visited instance's accumulator [4, 64] of walk 2 (slots
    resolved through cl_slot) added to its table row after its mesh walk.
    Returns (d_op_tab, cluster tests per ray of walk 1, of walk 2)."""
    box = cl_obox.t().contiguous()
    slots = cl_slot.long()
    d_op = torch.zeros_like(op_tab)
    tests = ([], [])
    for b0 in range(0, len(o), THREADS):
        sl = slice(b0, b0 + THREADS)
        ob, db = o[sl], d[sl]
        inv = safe_inv(db)
        blk = GradBlock(dist[sl], g[sl])
        zero = torch.zeros(len(ob))
        second = [False]

        def ineed(k):
            row = ti_rows[k]
            return blk.gate(*slab(row[0:3], row[3:6], ob, inv, pad=True),
                            blk.active)

        def visit_inst(k):
            row = ti_rows[k]
            in_k = ineed(k)
            oo, dd = tc._object_rays(ob, db, ti_rows, k)
            invl = safe_inv(dd)
            cl0, ncl, gid = (int(row[tc.TI_CL0]), int(row[tc.TI_NCL]),
                             int(row[tc.TI_ID]))
            acc = torch.zeros((4, tc.SLOTS))

            def cneed(s):
                return blk.gate(*slab(cl_obox[s, 0:3], cl_obox[s, 3:6], oo,
                                      invl, pad=True), in_k)

            def cvisit(s):
                proj = tc._project(oo, dd, box, frames, s)
                op = op_tab[gid][:, slots[s]]
                if second[0]:
                    acc.index_add_(1, slots[s], blk.scatter(*proj, cneed(s), op))
                else:
                    blk.take(*proj, cneed(s), op)

            for s0 in range(cl0, cl0 + ncl, mesh_window):
                rows = list(range(s0, min(cl0 + ncl, s0 + mesh_window)))
                if ncl <= SWEEP_MAX:
                    cands = [(-float("inf"), s) for s in rows]
                else:
                    cands = rank(rows, lambda s: (cl_obox[s, 0:3],
                                                  cl_obox[s, 3:6]),
                                 bounds(oo, dd, in_k & blk.live(), zero,
                                        blk.dist))
                walk(cands, blk.reach, in_k, cneed, cvisit)
            d_op[gid] += acc                        # flush_acc

        for w2 in (False, True):
            if w2:
                tests[0].append(blk.tests.clone())
                blk.tests.zero_()
                blk.second_walk()
                second[0] = True
            if not bool(blk.active.any()):
                continue
            ip = ti_rows.shape[0]
            for w0 in range(0, ip, window):
                rows = [k for k in range(w0, min(ip, w0 + window))
                        if ti_rows[k, tc.TI_NCL] > 0]
                b = bounds(ob, db, blk.live(), zero, blk.dist)
                walk(rank(rows, lambda k: (ti_rows[k, 0:3], ti_rows[k, 3:6]),
                          b), blk.reach, blk.active, ineed, visit_inst)
        tests[1].append(blk.tests)
    return d_op, torch.cat(tests[0]), torch.cat(tests[1])


def _cotangent(r, seed):
    """Random (g_rgb, g_a) with every fifth ray's zero (it takes no part)."""
    rng_ = np.random.default_rng(seed)
    g = torch.as_tensor(rng_.normal(size=(r, 4)).astype(np.float32))
    g[::5] = 0.0
    return g


def assert_grad_close(got, ref, rtol=1e-5):
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= rtol, err


@pytest.mark.parametrize("alpha", ["opaque", "half"])
def test_model_b2_grad_matches_plain_on_mesh_heavy_like_rays(alpha):
    """B2-grad's two walks against ``cluster_shadow_grad_plain`` (every
    cluster, no gate) on camera and bounce-like rays with dist = BIG, where
    opaque walls give rays one and several zero factors: the same
    gradient (the sums' order aside), walk 1 testing exactly the needed
    clusters of each ray (no stop), walk 2 no more."""
    world = rt.scenes.mesh_heavy(24, 24, resolution=40)
    scene = tds.compile_world(world, device="cpu")
    mc = scene.mat_color if alpha == "opaque" else half_translucent(scene.mat_color)
    op_tab = _soup_op(scene, mc)
    sets, near, far = scene_rays(scene, world, 24, seed=3)
    zero = torch.zeros(len(near))
    for i, (o, d) in enumerate(sets):
        g = _cotangent(len(o), seed=i)
        dist = torch.full((len(o),), float(BIG))
        ref = tc.cluster_shadow_grad_plain(o, d, dist, scene.cl_box,
                                           scene.cl_lw, op_tab, g[:, :3], g[:, 3])
        got, t1, t2 = model_shadow_grad(o, d, dist, scene.cl_box, scene.cl_lw,
                                        op_tab, g)
        assert_grad_close(got, ref)
        live = (g != 0).any(1)
        needed = ct.needed_soup(o[live], d[live], zero[live], dist[live],
                                scene.cl_box)[0]
        assert int(t1.sum()) == needed and int(t1[~live].sum()) == 0
        assert int(t2.sum()) <= int(t1.sum())
        assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("alpha", ["opaque", "half"])
@pytest.mark.parametrize("resolution", [8, 48])
def test_model_b4_grad_matches_plain_on_instanced_field_like_rays(resolution,
                                                                  alpha):
    """B4-grad's two walks (resolution 8: swept meshes; 48: ranked) against
    ``cluster_shadow_inst_grad_plain`` on camera and bounce-like rays with
    dist = BIG: the same gradient (the sums' order aside); walk 1 tests at
    least the needed (instance, cluster) pairs (the gates are widened),
    walk 2 no more than walk 1."""
    world = rt.scenes.instanced_field(16, 16, n=3, resolution=resolution)
    scene = tds.compile_world(world, two_level=True, device="cpu")
    mc = scene.mat_color if alpha == "opaque" else half_translucent(scene.mat_color)
    op_tab = tc.instance_opacity(mc, scene.inst_slot_map)
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot, op_tab)
    sets, near, far = scene_rays(scene, world, 16, seed=4)
    for i, (o, d) in enumerate(sets):
        g = _cotangent(len(o), seed=10 + i)
        dist = torch.full((len(o),), float(BIG))
        ref = tc.cluster_shadow_inst_grad_plain(o, d, dist, *tabs, g[:, :3],
                                                g[:, 3])
        got, t1, t2 = model_shadow_inst_grad(o, d, dist, *tabs, g)
        assert_grad_close(got, ref)
        live = (g != 0).any(1)
        needed = ct.needed_inst(o[live], d[live], torch.zeros(int(live.sum())),
                                dist[live], scene.ti_rows, scene.cl_obox)[0]
        assert int(t1.sum()) >= needed and int(t1[~live].sum()) == 0
        assert int(t2.sum()) <= int(t1.sum())
        assert float(ref.abs().max()) > 0


# ---------------------------------------------------------------------------
# the grouped walks (B1, B2 on tables above the grouped line)
# ---------------------------------------------------------------------------

def _groups(box_tab):
    return torch.as_tensor(tc.group_table(box_tab))


@pytest.mark.parametrize("table", ["mesh_heavy", "window", "ties",
                                   "two_level"])
def test_group_table(table):
    """Every real cluster box lies inside its group's box, which is their
    union; a group's first row and count of real rows are its rows'; a
    group of padding rows only is inverted (no slab reaches it), as a
    padding row is. "window" (1,100 real rows of 1,152) ends in a group
    that is part padding; "two_level" is a two-level scene's all-padding
    soup table."""
    if table == "mesh_heavy":
        scene = tds.compile_world(rt.scenes.mesh_heavy(16, 16, resolution=40),
                                  device="cpu")
        box, groups = scene.cl_box, scene.cl_group
        assert torch.equal(groups, _groups(box))
    elif table == "two_level":
        scene = tds.compile_world(rt.scenes.instanced_field(16, 16, n=3,
                                                            resolution=8),
                                  two_level=True, device="cpu")
        box, groups = scene.cl_box, scene.cl_group
    else:
        tabs = (ct.window_tables(rows=1100, n=300, seed=8) if table == "window"
                else ct.tie_tables(n=2400))
        box = torch.as_tensor(tabs["box_tab"])
        groups = _groups(box)
    cp = box.shape[1]
    assert groups.shape == (8, -(-cp // GROUP))
    real = box[tc.B_CNT] > 0
    for g in range(groups.shape[1]):
        rows = slice(g * GROUP, (g + 1) * GROUP)
        assert int(groups[tc.B_BASE, g]) == g * GROUP
        n = int(real[rows].sum())
        assert int(groups[tc.B_CNT, g]) == n
        lo, hi = groups[0:3, g], groups[3:6, g]
        if n == 0:
            assert bool((lo == 3e38).all() and (hi == -3e38).all())
            continue
        blo, bhi = box[0:3, rows][:, real[rows]], box[3:6, rows][:, real[rows]]
        assert bool((blo >= lo[:, None]).all() and (bhi <= hi[:, None]).all())
        assert torch.equal(blo.amin(1), lo) and torch.equal(bhi.amax(1), hi)
    counts = groups[tc.B_CNT]
    if table == "window":
        assert 0 < int(counts[int(real.sum()) // GROUP]) < GROUP   # part padding
        assert int((counts == 0).sum()) > 0
    if table == "two_level":
        assert int(counts.sum()) == 0
    bad = box.clone()
    bad[tc.B_CNT, 0] = 0.0           # a padding row ahead of real ones
    if int(real[:GROUP].sum()) > 1:
        with pytest.raises(ValueError):
            tc.group_table(bad)


def _above_the_line(seed=8):
    """A tiled table of 1,100 real rows (1,152 with padding): above the
    grouped line, its last real group part padding."""
    tabs = ct.window_tables(rows=1100, n=300, seed=seed)
    box, frames = (torch.as_tensor(tabs[k]) for k in ("box_tab", "frames"))
    assert box.shape[1] > tc.GROUPED_ROWS and tabs["real_rows"] % GROUP
    return tabs, box, frames


def test_model_b1_grouped_matches_plain_above_the_line():
    """The grouped B1 walk on a table above the line, with aimed rays and
    random ones that escape the grid: ids and t bit for bit as the plain
    version's, and the walk culls: fewer cluster visits than rows per
    block."""
    tabs, box, frames = _above_the_line()
    o, d, near, far = _table_rays(tabs, 512, seed=21)
    groups = _groups(box)
    entered = []
    *got, visits, _ = model_closest(o, d, near, far, box, frames,
                                    groups=groups, entered=entered)
    ref = tc.cluster_closest_plain(o, d, near, far, box, frames)
    assert_bits(got, ref)
    assert int((ref[1] >= 0).sum()) > len(o) // 4
    assert int((ref[1] < 0).sum()) > len(o) // 8           # escaping rays
    assert 0 < max(entered) <= int((groups[tc.B_CNT] > 0).sum())
    assert 0 < visits < tabs["real_rows"] * len(entered)


def test_model_b1_grouped_matches_plain_on_mesh_heavy_like_rays():
    """The grouped B1 walk on a real scene's table (mesh_heavy's, below the
    line: the model walks it grouped all the same), camera and bounce-like
    rays: bit for bit as the plain version's."""
    world = rt.scenes.mesh_heavy(24, 24, resolution=40)
    scene = tds.compile_world(world, device="cpu")
    sets, near, far = scene_rays(scene, world, 24, seed=3)
    for o, d in sets:
        *got, visits, _ = model_closest(o, d, near, far, scene.cl_box,
                                        scene.cl_lw, groups=scene.cl_group,
                                        entered=[])
        assert_bits(got, tc.cluster_closest_plain(o, d, near, far,
                                                  scene.cl_box, scene.cl_lw))
        assert visits > 0


def test_model_b1_grouped_ties_across_groups():
    """Every hit ties exactly in rows c and c + 32, which lie in groups 0
    and 1; the grown later row's group is entered first, and the earlier
    row must win, as in table order."""
    tabs = ct.tie_tables(n=2400)
    box, frames = (torch.as_tensor(tabs[k]) for k in ("box_tab", "frames"))
    m = tabs["real_rows"] // 2
    assert m == GROUP                     # the copies fill groups 0 and 1
    o, d, near, far = _table_rays(tabs, 384, seed=22)
    got = model_closest(o, d, near, far, box, frames, groups=_groups(box),
                        entered=[])[:2]
    ref = tc.cluster_closest_plain(o, d, near, far, box, frames)
    assert_bits(got, ref)
    hit = ref[1] >= 0
    assert int(hit.sum()) > 150
    assert bool((ref[1][hit] < box[tc.B_BASE, m].item()).all())


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_model_grouped_with_negative_near(kernel):
    """near < 0 on every other ray (B1), on the tie table across two
    groups: the groups all bound at -inf, so such blocks walk both levels
    in table order without the stop, and the result stays the plain
    version's. B2 takes hits at t > 0 only, whatever near is; its grouped
    walk meets the plain product under the forward gate on the same
    rays."""
    tabs = ct.tie_tables(n=2400)
    box, frames = (torch.as_tensor(tabs[k]) for k in ("box_tab", "frames"))
    o, d, near, far = _table_rays(tabs, 256, seed=23)
    near[::2] = -3.0
    if kernel == "b1":
        got = model_closest(o, d, near, far, box, frames, groups=_groups(box),
                            entered=[])[:2]
        ref = tc.cluster_closest_plain(o, d, near, far, box, frames)
        assert_bits(got, ref)
        assert bool((ref[0][(ref[1] >= 0)] < 0).any())  # a hit behind an origin
        return
    op = tc.cluster_opacity(*(torch.as_tensor(ct.soup_opacity(tabs, seed=24)[k])
                              for k in ("op_rgb", "op_a")),
                            torch.as_tensor(tabs["order"]),
                            box[tc.B_BASE].int(), box[tc.B_CNT].int())
    dist = torch.full((len(o),), float(BIG))
    got = model_shadow(o, d, dist, box, frames, op, groups=_groups(box),
                       entered=[])[:2]
    shadow_gate(got, tc.cluster_shadow_plain(o, d, dist, box, frames, op))


@pytest.mark.parametrize("alpha", ["translucent", "opaque"])
def test_model_b2_grouped_matches_plain_above_the_line(alpha):
    """The grouped B2 walk on the table above the line with dist = BIG:
    translucent opacities, whose products run over rows of many groups,
    and opaque ones, which block a ray at its first hit; rgba to the
    forward gate."""
    tabs, box, frames = _above_the_line()
    _, _, op_tab = _soup_tables(tabs, seed=25)
    if alpha == "opaque":
        op_tab = torch.zeros_like(op_tab)
    o, d, *_ = _table_rays(tabs, 512, seed=26)
    dist = torch.full((len(o),), float(BIG))
    entered = []
    *got, visits, _ = model_shadow(o, d, dist, box, frames, op_tab,
                                   groups=_groups(box), entered=entered)
    ref = tc.cluster_shadow_plain(o, d, dist, box, frames, op_tab)
    shadow_gate(got, ref)
    assert visits > 0 and max(entered) > 0
    if alpha == "translucent":
        assert int(((ref[1] > ALPHA_STOP) & (ref[1] < 0.5)).sum()) > 20
        assert int((ref[1] == 1).sum()) > len(o) // 8      # unblocked rays
    else:
        assert int((ref[1] == 0).sum()) > len(o) // 4


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_model_grouped_stops_at_the_wall(kernel):
    """Rays that hit a near wall along (1, 1, 1) on the table above the
    line (B2: opaque, dist = BIG): their lines cross several times the
    clusters they need, and the grouped walk tests at most twice the needed
    ones, as the flat walk does."""
    tabs, box, frames = _above_the_line()
    r = 512
    o, d = (torch.as_tensor(x) for x in ct.wall_rays(tabs["v0"], tabs["e1"],
                                                     tabs["e2"], r))
    zero, far = torch.zeros(r), torch.full((r,), 1e30)
    ref_t = tc.cluster_closest_plain(o, d, zero, far, box, frames)
    needed = ct.needed_soup(o, d, zero, ref_t[0], box)[0]
    on_line = ct.needed_soup(o, d, zero, far, box)[0]
    assert on_line >= 3 * needed > 0, (on_line, needed)
    if kernel == "b1":
        got_t, got_id, _, tests = model_closest(o, d, zero, far, box, frames,
                                                groups=_groups(box), entered=[])
        assert_bits((got_t, got_id), ref_t)
    else:
        op_tab = torch.zeros((box.shape[1], 4, tc.CLUSTER_T))
        dist = torch.full((r,), float(BIG))
        *got, _, tests = model_shadow(o, d, dist, box, frames, op_tab,
                                      groups=_groups(box), entered=[])
        shadow_gate(got, tc.cluster_shadow_plain(o, d, dist, box, frames,
                                                 op_tab))
    assert int(tests.sum()) <= 2 * needed, (int(tests.sum()), needed)


# ---------------------------------------------------------------------------
# the mesh sizes compile_world records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resolution,clusters", [(48, 24), (56, 32), (60, 40)])
def test_compile_world_records_the_mesh_clusters(resolution, clusters):
    """``compile_world`` records the largest real cluster count of a mesh
    (``max_ncl``): instanced_field's sphere has 24 clusters at resolution
    48 (its ground 1), 32 at 56 and 40 at 60. The padding rows, of
    instances (145 real rows of 256) and of clusters (each mesh padded to
    128 rows), are not counted."""
    world = rt.scenes.instanced_field(8, 8, n=12, resolution=resolution)
    scene = tds.compile_world(world, two_level=True, device="cpu")
    ncl = scene.ti_rows[:, tc.TI_NCL]
    real = ncl > 0
    assert int(real.sum()) == 145 < scene.ti_rows.shape[0]
    assert sorted(set(ncl[real].tolist())) == [1, clusters]
    assert scene.cl_obox.shape[0] == 256
    assert scene.max_ncl == int(ncl.max()) == clusters
