"""The layout probes `nbx_torch.bench.layoutsplit` and `layoutvar` against
`nbx.bench.layoutsplit` and `layoutvar` on the CPU, where the port's K2
wrapper runs its plain version.

The JAX probes hard-code `interpret=False`; here
`jax.experimental.pallas.pallas_call` is wrapped (monkeypatch) to set
`interpret=True`, and to hand out each launch's target block and event
output, whose partner column the probes themselves drop.

Scenes: the cloud at n = 4,096, g = 8, B = 4, buckets from
`bucketed_layout_for(..., split_quantile=0.8)`; and a clustered scene at
tiny caps, where target rows and strips are clipped and occupied windows
fall past bmax. Bucket 0's deltas and partners in body order equal the JAX
probe's (`layoutvar`'s "cur"): bounce counts and partners exactly, the other
columns to 1e-5 of each column's largest magnitude (float32 sums in another
order). The port's "blocks" layout is bitwise its "desc" layout. Two chained
steps of the port's stage split through "kernel" give the positions of two
steps of the JAX probe's chain through "epilogue".
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nbx.bench import layoutsplit as jlayoutsplit
from nbx.bench import layoutvar as jlayoutvar
from nbx.bench.granular import BOX
from nbx.config import body_radius as jax_body_radius
from nbx.config import default_materials
from nbx.ops import collide as jcollide
from nbx_torch.bench import layoutsplit, layoutvar
from nbx_torch.ops import collide, p3m

torch.set_num_threads(1)

FLOAT_TOL = 1e-5  # of each delta column's largest magnitude


def _cloud():
    box = BOX * (4096 / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = layoutsplit.granular_cloud(4096, box=box)
    return pos, vel, mass, 1.0, box, 8, 4, jcollide.bucketed_layout_for(jnp.asarray(pos), box, 8, 4,
                                                                          split_quantile=0.8)


def _clustered():
    """A uniform background and a dense clump, radii x 3: windows hold more
    than t_rows targets and strips more than s_capw lanes, and bmax = 6
    leaves occupied windows out."""
    rng = np.random.default_rng(11)
    bg = rng.uniform(10, 90, (200, 3))
    clump = rng.normal(35.0, 2.5, (200, 3))
    pos = np.clip(np.concatenate([bg, clump]), 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (400, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, 400).astype(np.float32)
    return pos, vel, mass, 3.0, BOX, 8, 4, ((6, 10, 6), (64, 64, 8))


SCENES = {"cloud": _cloud, "clustered": _clustered}


def _inputs(name):
    """(JAX arrays, torch tensors, box, g, band, buckets) of a scene, the
    JAX package's radii handed to both."""
    pos, vel, mass, scale, box, g, band, buckets = SCENES[name]()
    radius = jax_body_radius(jnp.asarray(mass), jnp.zeros(mass.shape, jnp.int32), default_materials()) * scale
    jax_args = tuple(jnp.asarray(x) for x in (pos, vel, mass)) + (radius,)
    torch_args = tuple(torch.from_numpy(np.asarray(x, np.float32).copy()) for x in (pos, vel, mass, radius))
    return jax_args, torch_args, box, g, band, tuple(tuple(int(v) for v in b) for b in buckets)


@pytest.fixture
def interpreted(monkeypatch):
    """pallas_call with interpret=True; each launch's (target block, event
    block) lands in the returned list."""
    launches = []
    real = pl.pallas_call

    def pallas_call(*args, **kw):
        call = real(*args, **{**kw, "interpret": True})

        def run(*operands):
            out = call(*operands)
            jax.debug.callback(lambda t, e: launches.append((np.asarray(t), np.asarray(e))), operands[1], out[1])
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    return launches


def _jax_partners(launches, n):
    """Body-order partners (-1 = none) from a launch's target block (its
    column 8 is the body id, -2 on padding rows) and event block (column 1
    the partner id)."""
    (tgt, evt), = launches
    out = np.full(n, -1, np.int64)
    rows = tgt[:, 8] >= 0
    out[tgt[rows, 8].astype(np.int64)] = evt[rows, 1].astype(np.int64)
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_bucket0_matches_nbx(scene, interpreted):
    jax_args, torch_args, box, g, band, buckets = _inputs(scene)
    n = torch_args[0].shape[0]
    _, once = jlayoutvar._make(*jax_args, box, g, band, buckets, "cur")
    want_d = np.asarray(once(jax_args[0]))
    want_j = _jax_partners(interpreted, n)
    b = layoutsplit.build(*torch_args, box, g, band, buckets[0])
    out_d, out_j = layoutsplit.launch(b, n)
    got_d = out_d.numpy()
    assert (got_d[:, 7] > 0).any(), "no bounces: the scene does not exercise the pass"
    assert np.array_equal(got_d[:, 7], want_d[:, 7])
    assert np.array_equal(out_j.numpy().astype(np.int64), want_j)
    for c in range(7):
        scale = max(float(np.abs(want_d[:, c]).max()), 1e-30)
        assert np.abs(got_d[:, c] - want_d[:, c]).max() <= FLOAT_TOL * scale, c
    if scene == "clustered":  # the caps clip and bmax leaves windows out
        _, starts, _ = p3m.cell_sort(torch_args[0], box, g)
        _, cnt, _, run9 = collide._window_tables(starts, g, band, collide._whole_grid(g, "cpu"))
        assert int((cnt > b.t_rows).sum()) > 0 and int((run9 > b.s_capw).sum()) > 0
        assert int((cnt > 0).sum()) > buckets[0][2]


@pytest.mark.parametrize("scene", list(SCENES))
def test_blocks_layout_is_bitwise_desc(scene):
    _, torch_args, box, g, band, buckets = _inputs(scene)
    desc = layoutvar.once(*torch_args, box, g, band, buckets[0], "desc")
    blocks = layoutvar.once(*torch_args, box, g, band, buckets[0], "blocks")
    assert all(torch.equal(a, b) for a, b in zip(desc, blocks))
    assert (desc[1] >= 0).any()


def test_stage_split_chain_matches_nbx(interpreted):
    """Two chained steps through the kernel against the JAX probe's chain
    through its epilogue."""
    jax_args, torch_args, box, g, band, buckets = _inputs("cloud")
    want = np.asarray(jlayoutsplit._stage_scans(*jax_args, box, g, band, buckets)("epilogue")(jax_args[0], 2))
    got = layoutsplit.chain(*torch_args, box, g, band, buckets[0], "kernel", 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_mains_on_the_cpu(capsys):
    """Each main at n = 4,096 (g = 8, B = 4) with device="cpu": one JSON
    line per N for the split, one per variant for the A/B, every launch
    through the K2 wrapper (none on the CPU)."""
    before = collide.collide_fused.launches
    split, = layoutsplit.main("4096", "8,4", steps=1, warmup=1, device="cpu")
    var, = layoutvar.main("4096", "8,4", steps=1, warmup=1, device="cpu")
    assert collide.collide_fused.launches == before
    assert all(split[f"ms_{s}"] > 0 for s in layoutsplit.STAGES) and split["device"] == "cpu"
    assert split["no_counterpart"] == list(layoutsplit.NO_COUNTERPART)
    assert all(var[f"ms_{v}"] > 0 for v in layoutvar.VARIANTS) and "mismatch_blocks" not in var
    assert len(capsys.readouterr().out.splitlines()) == 1 + len(layoutvar.VARIANTS)


@pytest.mark.parametrize("probe", ["layoutsplit", "layoutvar"])
def test_probe_entries_refuse_without_a_card(probe):
    """`python -m nbx_torch.bench.<probe>` where torch sees no card raises
    and prints no result."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": root}
    run = subprocess.run([sys.executable, "-m", f"nbx_torch.bench.{probe}", "4096", "8,4"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "torch sees none" in run.stderr and run.stdout == ""
