"""The spatial step's local collision entries (nbx_torch.ops.collide:
cell_sort_slabgrid, packed_collision_blocks_local,
bucketed_collision_blocks_local) and the plain version of the gravity-fused
kernel K7 against nbx.ops.collide's, called directly with a concrete slab
origin and the Pallas kernels in interpret mode: no mesh is needed.

A scene is one slab's rows: its owned rows, then the rows its neighbours'
boundary layers would send (halo rows), then junk rows (dead, or outside the
local grid), on 1-D and 2-D slab grids, at caps that cover and caps that
overflow, with and without the fused P3M short range. Partners (local rows),
bounces and n_overflow must agree exactly; the deltas and the gravity to
1e-5 of each field's largest magnitude (float32 sums in another order, the
port's erfc law with another association of the mass).

The file also holds the pair-set parity the JAX docstring claims at
zero-overflow caps: the union of D slabs' passes equals the whole grid's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.config import body_radius as jax_body_radius
from nbx.config import default_materials
from nbx.ops import collide as jcollide
from nbx_torch.ops import collide
from torch_parity import assert_close

torch.set_num_threads(1)

BOX = 100.0
G = 8
SG = (0.5, BOX / G / 3.0, 0.5)  # short gravity (G, a = cell / 3, eps), as the spatial step passes it


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _scene(seed=7, n=300, radius_scale=2.0):
    """A uniform background and three dense clumps (tests/test_torch_collide.py's
    clustered scene, a clump in a first, an inner and a last slab), with the
    JAX package's radii."""
    rng = np.random.default_rng(seed)
    n_bg = n // 2
    n_c = (n - n_bg) // 3
    parts = [rng.uniform(5, 95, (n_bg, 3))]
    parts += [rng.normal(c, 3.0, (n_c if i < 2 else n - n_bg - 2 * n_c, 3)) for i, c in enumerate((12.0, 37.0, 87.0))]
    pos = np.clip(np.concatenate(parts), 0.5, 99.5).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    r = jax_body_radius(jnp.asarray(mass), jnp.zeros(n, jnp.int32), default_materials())
    return pos, vel, mass, (np.asarray(r) * radius_scale).astype(np.float32)


def _slab_rows(pos, mass, d_x, d_y, me_x, me_y, two_d, junk=True):
    """Row ids of one slab's local rows: owned, then halo (the cells of the
    local grid outside the owned ones), then junk (dead owned copies and far
    rows, parked by the sort)."""
    cell = BOX / G
    c = np.clip((pos / cell).astype(np.int64), 0, G - 1)
    w_x, w_y = G // d_x, G // d_y if two_d else G
    lx = c[:, 0] - (me_x * w_x - 1)
    ly = c[:, 1] - (me_y * w_y - 1) if two_d else np.ones(len(pos), np.int64)
    gy = w_y + 2 if two_d else G + 2
    in_grid = (lx >= 0) & (lx < w_x + 2) & (ly >= 0) & (ly < gy)
    owned = (lx >= 1) & (lx <= w_x) & (ly >= 1) & (ly <= (w_y if two_d else G))
    halo = in_grid & ~owned
    rows = [np.nonzero(owned)[0], np.nonzero(halo)[0]]
    if junk:
        rows.append(np.nonzero(~in_grid)[0][:12])
    return np.concatenate(rows)


# (name, d_x, d_y, me_x, me_y, layout, short gravity); "covers": caps that
# hold every window of the scene, "overflows": a fraction of them (_caps)
CASES = [
    ("1d inner packed covers", 4, 1, 1, 0, "packed", False),
    ("1d inner packed covers, gravity", 4, 1, 1, 0, "packed", True),
    ("1d first slab packed overflows, gravity", 4, 1, 0, 0, "packed", True),
    ("1d last slab bucketed covers, gravity", 4, 1, 3, 0, "bucketed", True),
    ("1d inner bucketed overflows", 4, 1, 1, 0, "bucketed", False),
    ("1d whole grid packed covers, gravity", 1, 1, 0, 0, "packed", True),
    ("2d packed covers, gravity", 2, 4, 0, 1, "packed", True),
    ("2d packed overflows", 2, 4, 0, 1, "packed", False),
    ("2d last slab bucketed covers, gravity", 2, 4, 1, 3, "bucketed", True),
    ("2d first slab bucketed overflows, gravity", 2, 4, 0, 0, "bucketed", True),
]


def _caps(pos, layout, covers):
    """Packed caps, or two buckets, that cover the scene's windows, or that
    hold a third or a half as much (a budget of 2 windows in the last bucket)."""
    t, s = collide.packed_caps_for(pos, BOX, G, 2)
    if layout == "packed":
        return (t, s) if covers else (t // 3, s // 3)
    (t1, s1, _), (t2, s2, _) = collide.bucketed_layout_for(pos, BOX, G, 2, split_quantile=0.6)
    return ((t1, s1, 64), (t2, s2, 64)) if covers else ((t1 // 2, s1 // 2, 8), (t // 2, s // 2, 2))


def _jax_local(pos, vel, mass, radius, layout, caps, x0, w_x, y0, w_y, sg):
    """nbx's local entry, its outputs in body order: (out_d, partner, out_g
    or None, n_overflow)."""
    args = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(radius), BOX, G, 2, caps, 0.2, 0.5,
            x0, w_x, True, y0, w_y)
    n = pos.shape[0]
    if layout == "packed":
        outs = jcollide.packed_collision_blocks_local(*args, short_gravity=sg)
        if sg is None:
            delta, evt, slot, novf = outs
            grav = None
        else:
            delta, evt, grav, slot, novf = outs
        out_d, out_e = jcollide.epilogue_rows(delta, evt, slot)
        if grav is not None:
            gp = np.concatenate([np.asarray(grav), np.zeros((1, 8), np.float32)])
            grav = gp[np.clip(np.asarray(slot), 0, gp.shape[0] - 1)]
    else:
        outs = jcollide.bucketed_collision_blocks_local(*args, short_gravity=sg)
        out_d, out_e, grav, novf = outs if sg is not None else (*outs[:2], None, outs[2])
    out_e = np.asarray(out_e)
    has = out_e[:, 0] > 0
    partner = np.where(has, np.where(has, out_e[:, 1], -1.0).astype(np.int64), -1)
    assert partner.max() < n
    return np.asarray(out_d), partner, None if grav is None else np.asarray(grav)[:, :3], int(novf)


def _port_local(pos, vel, mass, radius, layout, caps, x0, w_x, y0, w_y, sg):
    fn = collide.packed_collision_blocks_local if layout == "packed" else collide.bucketed_collision_blocks_local
    outs = fn(_t(pos), _t(vel), _t(mass), _t(radius), BOX, G, 2, caps, 0.2, 0.5, x0, w_x, y0, w_y,
              short_gravity=sg)
    if sg is None:
        out_d, out_j, novf = outs
        out_g = None
    else:
        out_d, out_j, out_g, novf = outs
    return out_d.numpy(), out_j.numpy().astype(np.int64), None if out_g is None else out_g.numpy(), int(novf)


def _slab_args(d_x, d_y, me_x, me_y):
    two_d = d_y > 1
    w_x = G // d_x
    w_y = G // d_y if two_d else None
    return me_x * w_x - 1, w_x, (me_y * w_y - 1 if two_d else 0), w_y


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_local_entry_matches_jax(case):
    name, d_x, d_y, me_x, me_y, layout, grav = case
    pos, vel, mass, radius = _scene()
    caps = _caps(pos, layout, "covers" in name)
    rows = _slab_rows(pos, mass, d_x, d_y, me_x, me_y, d_y > 1)
    mass = mass.copy()
    mass[rows[-3:]] = 0.0  # dead rows are parked
    p, v, m, r = pos[rows], vel[rows], mass[rows], radius[rows]
    slab = _slab_args(d_x, d_y, me_x, me_y)
    sg = SG if grav else None
    got = _port_local(p, v, m, r, layout, caps, *slab, sg)
    want = _jax_local(p, v, m, r, layout, caps, *slab, sg)
    np.testing.assert_array_equal(got[1], want[1], err_msg="partners")
    assert got[3] == want[3], ("n_overflow", got[3], want[3])
    np.testing.assert_array_equal(got[0][:, 7], want[0][:, 7], err_msg="bounces")
    for i, field in enumerate(("dvx", "dvy", "dvz", "dpx", "dpy", "dpz", "heat")):
        assert_close(got[0][:, i], want[0][:, i], field)
    if grav:
        assert_close(got[2], want[2], "grav")
        assert np.abs(got[2]).max() > 0
    assert (got[1] >= 0).sum() > 0  # partners found
    assert (want[3] > 0) == ("overflows" in name)


@pytest.mark.parametrize("two_d", [False, True])
def test_cell_sort_slabgrid_and_neighbors_match(two_d):
    pos, _, mass, _ = _scene(seed=3)
    pos = np.concatenate([pos, np.float32([[-5.0, 50.0, 50.0], [120.0, 3.0, 4.0]])])  # out of the box
    alive = np.concatenate([mass, [1.0, 1.0]]) > 0
    alive[::7] = False
    x0, gx, y0, gy = (1, 4, 3, 4) if two_d else (-1, 4, 0, None)
    got = collide.cell_sort_slabgrid(_t(pos), _t(alive), BOX, G, x0, gx, y0, gy)
    want = jcollide.cell_sort_slabgrid(jnp.asarray(pos), jnp.asarray(alive), BOX, G, x0, gx, y0, gy)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gyy = gy if two_d else G
    np.testing.assert_array_equal(collide._column_neighbors_rect(gx, gyy).numpy(),
                                  np.asarray(jcollide._column_neighbors_rect(gx, gyy)))


def _union(pos, vel, mass, radius, d_x, d_y, caps, sg):
    """Each slab's local pass on its owned rows and its neighbours' boundary
    rows, written back to global body order (a body is owned by one slab)."""
    n = pos.shape[0]
    out_d = np.zeros((n, 8), np.float32)
    out_j = np.full(n, -1, np.int64)
    out_g = np.zeros((n, 3), np.float32)
    novf = 0
    for me_x in range(d_x):
        for me_y in range(d_y):
            rows = _slab_rows(pos, mass, d_x, d_y, me_x, me_y, d_y > 1, junk=False)
            d, j, g, o = _port_local(pos[rows], vel[rows], mass[rows], radius[rows], "packed", caps,
                                     *_slab_args(d_x, d_y, me_x, me_y), sg)
            tgt = (d != 0).any(1) | (j >= 0) | (np.abs(g) > 0).any(1)
            out_d[rows[tgt]] = d[tgt]
            out_j[rows[tgt]] = np.where(j[tgt] >= 0, rows[np.maximum(j[tgt], 0)], -1)
            out_g[rows[tgt]] = g[tgt]
            novf += o
    return out_d, out_j, out_g, novf


@pytest.mark.parametrize("d_x,d_y", [(4, 1), (8, 1), (2, 4)])
def test_union_of_slabs_is_the_whole_grid(d_x, d_y):
    """At zero-overflow caps (packed_caps_for), D slabs' local passes
    together give the whole grid's pass (one slab of g layers, no halo):
    the same deltas and gravity to 1e-5, the same partners and counts; and
    the whole grid's deltas and partners are binned_collision_pass's
    band-packed ones."""
    pos, vel, mass, radius = _scene(seed=11, n=300)
    caps = collide.packed_caps_for(pos, BOX, G, 2)
    whole = _port_local(pos, vel, mass, radius, "packed", caps, -1, G, 0, None, SG)
    assert whole[3] == 0 and (whole[1] >= 0).sum() > 0
    ref = collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(radius), BOX, G, band_cells=2,
                                        packed_caps=caps)
    np.testing.assert_array_equal(whole[1], ref[3]["j"].numpy())
    assert_close(whole[0][:, 0:3], ref[0].numpy(), "dvel")
    got = _union(pos, vel, mass, radius, d_x, d_y, caps, SG)
    assert got[3] == 0
    np.testing.assert_array_equal(got[1], whole[1], err_msg="partners")
    np.testing.assert_array_equal(got[0][:, 7], whole[0][:, 7], err_msg="bounces")
    assert_close(got[0], whole[0], "deltas")
    assert_close(got[2], whole[2], "grav")


def test_grav_wrapper_counts_no_cpu_launch():
    """collide_fused_grav on CPU tensors runs the plain version and counts
    nothing; its collision outputs are collide_fused's."""
    pos, vel, mass, radius = _scene()
    before = (collide.collide_fused.launches, collide.collide_fused_grav.launches)
    a = collide.packed_collision_blocks_local(_t(pos), _t(vel), _t(mass), _t(radius), BOX, G, 2, (40, 64), 0.2,
                                              0.5, -1, G)
    b = collide.packed_collision_blocks_local(_t(pos), _t(vel), _t(mass), _t(radius), BOX, G, 2, (40, 64), 0.2,
                                              0.5, -1, G, short_gravity=SG)
    assert (collide.collide_fused.launches, collide.collide_fused_grav.launches) == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and int(a[2]) == int(b[3])
