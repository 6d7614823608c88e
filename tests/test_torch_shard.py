"""nbx_torch.parallel.shard (the all-gather paths on torch.distributed) and the
column-slab entry `ops.collide.packed_collision_blocks_slab` against
nbx.parallel.shard and nbx.ops.collide, on the scenes of tests/test_shard.py.

The port's paths run in gloo ranks, spawned once per world (8 ranks with a
1-D mesh of 8 and a 2x4 mesh, and one rank for D = 1), every scene inside
them (tests/torch_shard_ranks.py). The JAX paths run in a worker subprocess
per world with its own 8 virtual CPU devices (tests/torch_shard_jax_worker.py),
as tests/test_multihost.py runs its JAX workers: the suite's own process has
one device, where tests/test_shard.py skips. All of them start together and
write npz files.

Held: the port's rows, joined in rank order, equal the JAX paths' global
arrays after every step: ids, partners, mat and every counter exactly; every
float field to 1e-5 of its largest magnitude (float32 sums in another
order). Fractures get the JAX steps' uniforms (the key each step passes to
`_make_fragments`), rebuilt here, the same for every rank. Then each scene's
own claims from tests/test_shard.py on the port's result, and the slab entry
alone, with no mesh, against the JAX package's."""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx_torch import convert
from torch_parity import assert_close, fragment_draws, jax_scan_draws
from torch_shard_ranks import (BODY_FIELDS, BOX, GRANULAR_COUNTERS, GRANULAR_LAYOUT, GRAVITY_FIELDS, KINDS,
                               PASS_KEYS, PHYSICS_COUNTERS, SCENES, binned_arrays, draws_key, granular_arrays,
                               physics_arrays, port_config)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DEADLINE_S = 600
EXACT = ("mat", "partner")
EXACT_PASS = ("j", "approaching", "n_bounces", "n_overflow", "cell_too_small")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_draws(path: str) -> None:
    """The fracture uniforms of every fracturing scene's steps: the physics
    step passes its key to _make_fragments as it is; the granular step gets
    `sub` of split(key) each step, as the JAX tests drive it."""
    out = {}
    for name, sc in SCENES.items():
        if name in ("fracture", "fracture_scaled"):
            steps = [fragment_draws(jax.random.PRNGKey(sc["key"]), port_config(name))]
        elif sc["kind"] == "granular":
            steps = jax_scan_draws(jax.random.PRNGKey(sc["key"]), port_config(name), sc["steps"])
        else:
            continue
        for i, d in enumerate(steps):
            out.update({f"{draws_key(name, i)}/{f}": getattr(d, f).numpy()
                        for f in ("u0", "u_mass", "u_dir", "u_off", "u_speed")})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX workers and the port's ranks together; wait for all."""
    out = str(tmp_path_factory.mktemp("shard"))
    _write_draws(os.path.join(out, "draws.npz"))
    procs = []
    jenv = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for kind in KINDS:
        procs.append((f"jax {kind}", subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_shard_jax_worker.py"), kind, out], env=jenv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tenv = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    for kind, world in KINDS.items():
        port = _free_port()
        for r in range(world):
            procs.append((f"rank {kind} {r}", subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_shard_ranks.py"), kind, str(r), str(world), str(port),
                 out], env=tenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline = time.time() + DEADLINE_S
    failed = []
    try:
        for what, p in procs:
            log, _ = p.communicate(timeout=max(5.0, deadline - time.time()))
            if p.returncode != 0:
                failed.append(f"{what} exited {p.returncode}:\n{log[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)
    return out


def _load(out: str, kind: str, name: str):
    """(port, jax): the port's ranks' rows joined in rank order (values that
    are alike on every rank, as rank 0 holds them, checked equal on every
    rank), and the JAX paths' global arrays."""
    parts = [dict(np.load(os.path.join(out, kind, f"{name}_r{r}.npz"))) for r in range(KINDS[kind])]
    want = dict(np.load(os.path.join(out, kind, f"{name}_jax.npz")))
    port = {}
    for k in parts[0]:
        if parts[0][k].ndim >= 1 and k.split("/")[-1] not in ("energies",):
            port[k] = np.concatenate([p[k] for p in parts])
        else:
            port[k] = parts[0][k]
            for p in parts[1:]:
                np.testing.assert_array_equal(p[k], port[k], err_msg=k)
    return port, want


def _same_keys(port: dict, want: dict) -> None:
    assert set(port) == set(want), (sorted(set(port) ^ set(want)))


def _match(port: dict, want: dict, exact=("mat", "partner")) -> None:
    """Every key: counters ("/c/"), exact fields and non-float arrays
    exactly; float fields to 1e-5 of their largest magnitude."""
    _same_keys(port, want)
    for k in sorted(want):
        field = k.split("/")[-1]
        if "/c/" in k or field in exact or want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(port[k], want[k], err_msg=k)
        else:
            assert_close(port[k], want[k], k)


KIND_IDS = list(KINDS)


def _scenes(kind: str) -> list:
    return [name for name, sc in SCENES.items() if sc["kind"] == kind]


@pytest.mark.parametrize("kind", KIND_IDS)
@pytest.mark.parametrize("name", _scenes("gravity"))
def test_gravity_steps_match_jax(runs, kind, name):
    """The 1-D, 2-D and ring steps, every step, against the JAX package's."""
    port, want = _load(runs, kind, name)
    for path in SCENES[name]["steps_of"]:
        for f in GRAVITY_FIELDS:
            np.testing.assert_array_equal(port[f"{path}/0/{f}"], want[f"{path}/0/{f}"], err_msg=f"{path} placement")
    _match(port, want)


@pytest.mark.parametrize("kind", KIND_IDS)
def test_2d_and_ring_match_1d(runs, kind):
    """tests/test_shard.py's claims: the 2-D step and the ring equal the 1-D
    step to float32 order (rtol 1e-5, atol 1e-6 there; 1e-5 of the largest
    magnitude here); at D = 1 bitwise."""
    for name, path in (("mesh2d", "2d"), ("ring", "ring")):
        port, _ = _load(runs, kind, name)
        n = SCENES[name]["steps"]
        for f in ("pos", "vel"):
            a, b = port[f"{path}/{n}/{f}"], port[f"1d/{n}/{f}"]
            if kind == "d1":
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {f}")
            else:
                assert_close(a, b, f"{name} {f}")


@pytest.mark.parametrize("kind", KIND_IDS)
@pytest.mark.parametrize("name", ["energy", "drift"])
def test_energy_matches_jax(runs, kind, name):
    """sharded_energy through K3's plain version and run_sharded's samples
    against the JAX package's; the drift claim of tests/test_shard.py."""
    port, want = _load(runs, kind, name)
    _match(port, want)
    if name == "drift":
        assert port["energies"].shape == (2, 2)
        e0, e1 = float(port["ke0"] + port["pe0"]), float(port["ke1"] + port["pe1"])
        assert abs(e1 - e0) / abs(e0) < 1e-3


@pytest.mark.parametrize("kind", KIND_IDS)
@pytest.mark.parametrize("name", _scenes("physics"))
def test_physics_step_matches_jax(runs, kind, name):
    """The dense full-physics step, every step: states, partners (global
    ids) and counters."""
    port, want = _load(runs, kind, name)
    _match(port, want)


def _totals(port: dict, i: int):
    m, v = port[f"{i}/mass"], port[f"{i}/vel"]
    return m, (m[:, None] * v).sum(0)


def test_physics_claims(runs):
    """tests/test_shard.py's claims on the port's 8-rank results: the
    cross-shard bounce (momentum, heat, mutual partners), the merge into the
    lower global slot, the fracture into dead slots across shards."""
    port, _ = _load(runs, "d8", "bounce")
    assert int(port["1/c/n_bounces"]) == 1
    m, p = _totals(port, 1)
    np.testing.assert_allclose(p, 0.0, atol=1e-4)
    v = port["1/vel"]
    assert v[0, 0] < 1.0 and v[15, 0] > -1.0 and port["1/temp"][0] > 0
    assert port["1/partner"][0] == 15 and port["1/partner"][15] == 0

    port, _ = _load(runs, "d8", "merge")
    n = int(port["steps"])
    assert sum(int(port[f"{i}/c/n_merges"]) for i in range(1, n + 1)) == 1
    m, p = _totals(port, n)
    np.testing.assert_allclose(m.sum(), 16.0, rtol=1e-6)
    assert m[0] == 16.0 and m[15] == 0.0
    np.testing.assert_allclose(p, 0.0, atol=1e-3)
    assert port[f"{n}/partner"][0] == -1 and port[f"{n}/contact_t"][0] == 0.0

    port, _ = _load(runs, "d8", "fracture")
    assert int(port["1/c/n_fractures"]) == 1
    m, p = _totals(port, 1)
    assert (m > 0).sum() >= 3 and m.sum() <= 20.0 + 1e-4
    e_imp = 0.5 * (10.0 * 10.0 / 20.0) * 8.0**2
    assert np.abs(p).max() < 20.0 * 1.5 * np.sqrt(e_imp / 20.0)
    assert np.isfinite(port["1/pos"]).all() and port["1/temp"][m > 0].max() > 0


def test_fracture_matches_scaled_semantics(runs):
    """The sharded fracture fires under the gate of the single-device scaled
    path on the same scene: the port's and the JAX package's
    resolve_collisions_scaled and the port's 8-rank step each fire one, and
    none creates mass."""
    from nbx.collisions_scaled import make_granular_state as jax_state
    from nbx.collisions_scaled import resolve_collisions_scaled as jax_resolve
    from nbx.config import SimConfig as JaxConfig

    from nbx_torch.collisions_scaled import make_granular_state, resolve_collisions_scaled
    from torch_shard_ranks import PHYSICS_CFG

    pos, vel, mass = physics_arrays("fracture_scaled")
    jst, jev = jax_resolve(jax_state(pos, vel, mass, key=3), JaxConfig(**PHYSICS_CFG["fracture_scaled"]), 0.016,
                           100.0, n_cells=8, max_per_cell=8, interpret=True)
    st, ev = resolve_collisions_scaled(make_granular_state(pos, vel, mass, device="cpu"),
                                       port_config("fracture_scaled"), 0.016, 100.0, n_cells=8, max_per_cell=8)
    port, _ = _load(runs, "d8", "fracture_scaled")
    assert int(port["1/c/n_fractures"]) == int(ev.n_fractures) == int(jev.n_fractures) == 1
    assert port["1/mass"].sum() <= 20.0 + 1e-4 and float(st.mass.sum()) <= 20.0 + 1e-4
    assert float(jnp.sum(jst.mass)) <= 20.0 + 1e-4


@pytest.mark.parametrize("kind", KIND_IDS)
def test_binned_pass_matches_jax(runs, kind):
    """The column-slab sharded pass: partners (global ids), bounces, overflow
    and the cell flag exactly, deltas and the partner record to 1e-5."""
    port, want = _load(runs, kind, "binned")
    assert set(want) == set(PASS_KEYS)
    _match(port, want, exact=EXACT_PASS)
    assert int(port["n_bounces"]) > 0 and int(port["n_overflow"]) == 0


@pytest.mark.parametrize("kind", KIND_IDS)
def test_binned_pass_matches_single_device(runs, kind):
    """tests/test_shard.py's claim on the port: the sharded pass equals the
    port's single-device binned_collision_pass (packed), partners and
    counters exactly, deltas to 1e-6."""
    from nbx_torch.ops.collide import binned_collision_pass

    sc = SCENES["binned"]
    port, _ = _load(runs, kind, "binned")
    t = [torch.from_numpy(x) for x in binned_arrays()]
    dv, dp, dt, best, nb, novf, small = binned_collision_pass(*t, BOX, sc["g"], band_cells=sc["band"],
                                                               packed_caps=sc["caps"])
    np.testing.assert_array_equal(port["j"], best["j"].numpy())
    assert int(port["n_bounces"]) == int(nb) and int(port["n_overflow"]) == int(novf)
    assert bool(port["cell_too_small"]) == bool(small)
    for k, x in (("dvel", dv), ("dpos", dp), ("dtemp", dt), ("vn", best["vn"])):
        np.testing.assert_allclose(port[k], x.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", KIND_IDS)
@pytest.mark.parametrize("name", _scenes("granular"))
def test_granular_step_matches_jax(runs, kind, name):
    """The sharded granular step (the slab pass, merges, fractures across
    shards, fragment slots, timers), every step: states and counters."""
    port, want = _load(runs, kind, name)
    _match(port, want)
    n = SCENES[name]["steps"]
    tot = {k: sum(int(port[f"{i}/c/{k}"]) for i in range(1, n + 1)) for k in GRANULAR_COUNTERS}
    assert tot["n_bounces"] > 0 and tot["n_overflow"] == 0
    if name == "granular_zero":
        assert tot["n_merges"] > 0 and tot["n_fractures"] > 0


def test_granular_step_matches_the_ports_single_device_sequence(runs):
    """tests/test_shard.py's chain on the port: the 8-rank granular step
    without gravity equals the single-device sequence [half-kick, drift,
    resolve_collisions_scaled(packed), acc 0 on touched, half-kick,
    thermal.decay] with the same uniforms: counters, partners, contact
    timers and materials exactly, floats to 1e-5."""
    from nbx_torch import thermal
    from nbx_torch.collisions_scaled import make_granular_state, resolve_collisions_scaled

    name = "granular_zero"
    sc = SCENES[name]
    box, g, band, caps = GRANULAR_LAYOUT
    cfg = port_config(name)
    port, _ = _load(runs, "d8", name)
    draws = jax_scan_draws(jax.random.PRNGKey(sc["key"]), cfg, sc["steps"])
    st = make_granular_state(*granular_arrays(sc["seed"]), device="cpu")
    h = sc["h"]
    for i in range(sc["steps"]):
        v = st.vel
        st = st.replace(pos=st.pos + v * h, vel=v)
        st, ev = resolve_collisions_scaled(st, cfg, h, box, g, band_cells=band, packed_caps=caps, draws=draws[i])
        st = st.replace(temp=thermal.decay(st.temp, cfg.heat_decay))
        for k in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped"):
            assert int(port[f"{i + 1}/c/{k}"]) == int(getattr(ev, k)), (i, k)
    got = {f: port[f"{sc['steps']}/{f}"] for f in BODY_FIELDS}
    for f in ("mat", "partner", "contact_t"):
        np.testing.assert_array_equal(got[f], getattr(st, f).numpy(), err_msg=f)
    for f in ("pos", "vel", "mass", "temp"):
        assert_close(got[f], getattr(st, f).numpy(), f)


def test_bad_splits_and_indivisible_n(runs):
    """g^2 columns that do not divide over the mesh and an N that does not
    divide raise ValueError on 8 ranks, as in the JAX package (with its
    messages' words); at D = 1 both divide, on both sides."""
    for kind in KIND_IDS:
        port, want = _load(runs, kind, "bad")
        _same_keys(port, want)
        for k in want:
            if kind == "d1":
                assert str(port[k]) == str(want[k]) == "no error", k
            else:
                word = "divisible" if k.endswith("indivisible") else "columns"
                assert word in str(port[k]) and word in str(want[k]), (k, port[k], want[k])


@pytest.mark.parametrize("kind", KIND_IDS)
def test_convert_round_trip(runs, kind):
    """convert maps the JAX paths' global arrays to each rank's ShardedState
    and ShardedBodyState and back, row for row."""
    d = KINDS[kind]
    _, want = _load(runs, kind, "granular_zero")
    arrays = {f: want[f"4/{f}"] for f in BODY_FIELDS}
    states = [convert.sharded_body_state_from_arrays(arrays, r, d, device="cpu") for r in range(d)]
    assert all(s.pos.shape[0] == 512 // d for s in states)
    back = convert.sharded_body_state_to_arrays(*states)
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)
        assert back[f].dtype == v.dtype, f
    _, want = _load(runs, kind, "single")
    arrays = {f: want[f"1d/5/{f}"] for f in GRAVITY_FIELDS}
    states = [convert.sharded_state_from_arrays(arrays, r, d, device="cpu") for r in range(d)]
    back = convert.sharded_state_to_arrays(*states)
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)


# ---- the slab entry alone, no mesh ------------------------------------------------------

# caps that cover the binned scene's windows and strips (packed_caps_for: (73, 118)), and caps that do not
SLAB_CASES = [("covers", (73, 118)), ("overflows", (24, 40))]


@pytest.mark.parametrize("caps_label,caps", SLAB_CASES)
@pytest.mark.parametrize("n_slabs", [2, 4, 8])
def test_slab_entry_matches_jax(caps_label, caps, n_slabs):
    """The port's packed_collision_blocks_slab (its plain version, on the
    CPU) against nbx.ops.collide.packed_collision_blocks_slab +
    epilogue_rows on each slab of a split of tests/test_shard.py's binned
    scene: the slab's target rows equal the JAX rows (partners, bounces and
    n_overflow exactly; deltas to 1e-5), every other row is zero with
    partner -1; the sum over the slabs is the whole-grid packed pass
    (bitwise) and its n_overflow the whole grid's."""
    from nbx.ops.collide import epilogue_rows, packed_collision_blocks_slab

    # col_lo traced, as the JAX sharded pass calls it: one compile a split
    jax_slab = jax.jit(packed_collision_blocks_slab, static_argnums=(4, 5, 6, 7, 8, 9, 11, 12))

    from nbx_torch.ops.collide import binned_collision_pass
    from nbx_torch.ops.collide import packed_collision_blocks_slab as port_slab

    g, b = 4, 2
    arrays = binned_arrays()
    t = [torch.from_numpy(x) for x in arrays]
    j_in = [jnp.asarray(x) for x in arrays]
    k = g * g // n_slabs
    sum_d = torch.zeros((t[0].shape[0], 8))
    max_j = torch.full((t[0].shape[0],), -1, dtype=torch.int32)
    n_ovf = 0
    for s in range(n_slabs):
        out_d, out_j, novf = port_slab(*t, BOX, g, b, caps, 0.2, 0.5, s * k, k)
        delta, evt, body_slot, jnovf = jax_slab(*j_in, BOX, g, b, caps, 0.2, 0.5, s * k, k, True)
        jd, je = (np.asarray(x) for x in epilogue_rows(delta, evt, body_slot))
        mine = np.asarray(body_slot) < delta.shape[0]
        has = mine & (je[:, 0] > 0)
        jj = np.where(has, je[:, 1], -1.0).astype(np.int32)
        np.testing.assert_array_equal(out_j.numpy(), jj, err_msg=f"slab {s} partners")
        np.testing.assert_array_equal(out_d[:, 7].numpy(), np.where(mine, jd[:, 7], 0.0), err_msg=f"slab {s} bounces")
        assert_close(out_d[:, :7].numpy(), np.where(mine[:, None], jd[:, :7], 0.0), f"slab {s} deltas")
        assert int(novf) == int(jnovf), (s, int(novf), int(jnovf))
        sum_d += out_d
        max_j = torch.maximum(max_j, out_j)
        n_ovf += int(novf)
    dv, dp, dt, best, nb, novf, _ = binned_collision_pass(*t, BOX, g, band_cells=b, packed_caps=caps)
    assert torch.equal(sum_d[:, :3], dv) and torch.equal(sum_d[:, 3:6], dp) and torch.equal(sum_d[:, 6], dt)
    assert torch.equal(max_j, best["j"]) and int(sum_d[:, 7].sum()) // 2 == int(nb)
    assert n_ovf == int(novf)
    assert (n_ovf > 0) == (caps_label == "overflows")


def test_slab_entry_rejects_columns_off_the_grid():
    from nbx_torch.ops.collide import packed_collision_blocks_slab

    t = [torch.from_numpy(x) for x in binned_arrays()]
    with pytest.raises(ValueError, match="outside"):
        packed_collision_blocks_slab(*t, BOX, 4, 2, (64, 96), 0.2, 0.5, 12, 8)


def test_impl_names_and_forces():
    """The JAX package's impl names are accepted (the device decides), others
    refused; the granular step has no "p3m" force (the JAX package has
    none), and the 1-D paths refuse a 2-D mesh."""
    import torch.distributed as dist

    from nbx_torch.config import SimConfig
    from nbx_torch.parallel import shard

    with shard.local_world("gloo"):
        mesh = shard.make_mesh(device_type="cpu")
        for impl in shard.IMPLS:
            shard.make_sharded_step(mesh, impl=impl)
        with pytest.raises(ValueError, match="impl"):
            shard.make_sharded_step(mesh, impl="mxu")
        with pytest.raises(ValueError, match="force_impl"):
            shard.make_sharded_granular_step(mesh, SimConfig(), BOX, 4, 2, (64, 96), force_impl="p3m")
        mesh2 = shard.make_mesh(axes=("b", "j"), device_type="cpu")
        with pytest.raises(ValueError, match="1-D mesh"):
            shard.make_sharded_step(mesh2)
        with pytest.raises(ValueError, match="2-D mesh"):
            shard.make_sharded_step_2d(mesh)
    assert not dist.is_initialized()


def test_bench_sharded_cells_on_the_cpu():
    """bench.sharded's two cells at a small size in a gloo world of one rank:
    timed, on the device they ran on, the granular counters those of the
    step."""
    from nbx_torch import scene
    from nbx_torch.bench import sharded
    from nbx_torch.parallel import shard

    dev = torch.device("cpu")
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(device_type="cpu")
        sc = scene.galaxy_merger(2048, **sharded.MERGER)
        rec, st = sharded.time_gravity(mesh, dev, sc, steps=1, warmup=1)
        assert rec["n"] == 2048 and rec["d"] == 1 and rec["device"] == "cpu" and rec["ms_per_step"] > 0
        assert torch.isfinite(st.pos).all()
        rec = sharded.time_granular(mesh, dev, 2048, "zero", steps=1, warmup=1)
        assert rec["force"] == "zero" and rec["ms_per_step"] > 0
        assert set(rec["counters"]) == set(GRANULAR_COUNTERS) and rec["counters"]["n_bounces"] >= 0


def test_bench_sharded_refuses_without_a_card(monkeypatch):
    from nbx_torch.bench import sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharded.main(["--ranks", "1"])
