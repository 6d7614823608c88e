"""The `precision` switch of the port's `pairwise_acc` ("f32", "fast", "hyb",
"bf16" and "mxu": K1a, K1b, K1d, K1e, K1c) and of its gravity-only
benchmarks, against `nbx` on the CPU, where the port's wrappers run their
plain versions.

`nbx` runs its Pallas kernels in interpret mode at tile_i=8, tile_j=128,
compiled with XLA's `xla_allow_excess_precision` off: XLA's CPU backend
otherwise drops the bf16 round trips (float32 -> bf16 -> float32) inside
the interpreted kernels, so that "bf16" and "fast" would skip roundings the
TPU makes (measured: "bf16" then differs from its own rounding points by
8e-3 of max|acc| at n = 777). The port's plain versions run at tile=128,
`nbx`'s tile_j: "fast", "hyb" and "mxu" centre on each 128-lane tile, and
"f32", "fast", "hyb" and "mxu" sum tile by tile.

Bars, max|port - nbx| / max|nbx|, from the measured values:

- "bf16" 1e-5 (measured at most 4.0e-7): the same bf16 and float32
  roundings at the same points; only the float32 row sums run in another
  order, and nothing cancels.
- "f32" 2e-3 (measured at most 1.21e-3, at n = 64; with the kernel's FMAs
  in r^2 and the sums followed in its plain version: 1.213e-3, 3.988e-4,
  2.867e-4, 1.654e-4 on n = 64, 300, 777 and "rect", the FMA-free sums'
  values to four digits), "fast" 2e-3 (at most 1.30e-3, at n = 300), "hyb"
  2e-3 (at most 1.71e-3, at n = 64; with the
  kernel's FMAs followed in its plain version: 1.712e-3, 4.093e-4,
  2.513e-4, 2.171e-4 on n = 64, 300, 777 and "rect", where FMA-free sums
  gave 1.712e-3, 3.366e-4, 2.513e-4, 2.171e-4). These cancel, and XLA's dot and mean and the port sum in other orders. "f32"
  and "fast" end in o_xyz - p_i o_m, where o_xyz = sum_j f m x_j is
  dominated by the self pair, 8 m_i x_i (f = eps^-3), up to 1,865 at
  n = 64: one float32 ulp of it (1.2e-4) is 4.6e-4 of max|acc| after G,
  and the two orders differ by up to 2.6 ulps. "fast" also moves by about
  1e-3 with the last bit of a tile's centroid, through its bf16 splits of
  S - c m (the dropped lo lo term; its own error against float64 is
  2.6e-3 to 2.5e-2 here). "hyb" un-centres each tile as
  s - (p_i - c) sum_j w, where the self pair's w (p_i - c) cancels in the
  same way. No bar below that noise holds unless both sides sum in the same
  order; on the card the kernels and their plain versions do
  (`tests/test_torch_cuda.py`).
- "mxu" 2e-3 where targets are sources (measured 6.90e-4 at n = 64,
  1.98e-4 at 300, 1.42e-4 at 777, 1.21e-4 on "rect"), 1e-4 where they
  are not (`test_mxu_without_self_pairs_matches_nbx`, measured 1.77e-5,
  1.23e-6, 7.65e-7). A self pair leaves -(w_hi + w_lo)(P_c - P_hi - P_lo)
  - w_lo P_lo in tmp_xyz - (p_i - c) tmp_w, about 2^-17 of w_ii |p_i - c|,
  which moves with the last bits of w_ii and of the centroid; so the plain
  version rounds them where XLA's CPU code does (the centroid summed in
  blocks of 32 lanes, the squares and the cross term contracted into FMAs;
  `_mxu_rows`). With the halving-tree centroid and FMA-free sums of the
  other variants it stood 1.84e-2 from `nbx` at n = 64. That residual is
  most of "mxu"'s own error: against float64, 3.50e-2, 4.19e-3, 3.00e-3,
  3.84e-3 for `nbx` on n = 64, 300, 777 and "rect".
  `test_mxu_error_class_matches_nbx` holds the port's error against float64
  to between 0.9x and 1.1x `nbx`'s on each of the four cases (measured
  1.006x, 0.985x, 1.020x, 1.016x). `test_mxu_checks_reject_other_formulations`
  is the control of both: each other precision's plain version put in
  "mxu"'s place fails the 2e-3 bar on every self-pair case (measured
  3.00e-3 to 5.22e-2 from `nbx`), fails the separate-target bar ("f32r"
  4.11e-4, "f32" 4.10e-4, "fast" 4.18e-4, "hyb" 6.31e-4, "bf16" 8.65e-3 at
  their worst seed), and leaves the error class on at least one case, on
  every case for the three that split nothing into bf16. Measured ratios:
  "f32r" 0.000x (to three places) on every case, "f32" 0.038x-0.161x,
  "hyb" 0.061x-0.155x, "fast" 0.718x, 0.946x, 0.854x, 0.830x (inside the
  band at n = 300 only), "bf16" 0.115x, 0.822x, 1.642x, 0.495x.
- The error ladder, against a float64 direct sum on
  `tests/test_tpu_only.py`'s `_rand(2048, seed=1)` at the card's tile:
  "f32" < 1e-3, "fast" < 1e-2, "hyb" < 0.02, "bf16" < 5e-2 and > 0 (bf16
  really in use, as `tests/test_kernel.py`'s budget test asks), "mxu" < 0.02
  (`tests/test_kernel.py:142-153`'s budget; measured 2.52e-3).
- `drift_run` at each precision against `nbx`'s (N = 128, 200 steps, as
  `tests/test_bench.py` runs it): 1e-5 of the largest magnitude in the
  energies, positions and velocities (measured at most 6.8e-7): the port's
  plain versions sum over a 256-lane tile, `nbx` over its default 2048.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx.bench import drift as jdrift
from nbx.ops import pairwise as jpairwise
from nbx_torch import __main__ as cli
from nbx_torch.bench import drift, latency, throughput
from nbx_torch.ops import pairwise

torch.set_num_threads(1)

VARIANTS = ("f32", "fast", "hyb", "bf16", "mxu")
NBX_BAR = {"f32": 2e-3, "fast": 2e-3, "hyb": 2e-3, "bf16": 1e-5, "mxu": 2e-3}
LADDER = {"f32": 1e-3, "fast": 1e-2, "hyb": 0.02, "bf16": 5e-2, "mxu": 0.02}
MXU_SEPARATE_BAR = 1e-4  # "mxu" against nbx where no target is a source
MXU_ERROR_CLASS = (0.9, 1.1)  # "mxu"'s error against float64 over nbx's
DRIFT_TOL = 1e-5
NO_EXCESS = {"xla_allow_excess_precision": False}


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    mass = rng.uniform(0.5, 5, n).astype(np.float32)
    return pos, mass


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _nbx_acc(pos, mass, precision, target_pos=None):
    args = (jnp.asarray(pos), jnp.asarray(mass), 0.5, 0.5, None if target_pos is None else jnp.asarray(target_pos))
    run = jpairwise.pairwise_acc.lower(*args, tile_i=8, tile_j=128, precision=precision, interpret=True)
    return np.asarray(run.compile(NO_EXCESS)(*args))


def _f64_acc(pos, mass, target_pos=None):
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    t = p if target_pos is None else target_pos.astype(np.float64)
    d = p[None] - t[:, None]
    r2 = (d * d).sum(-1) + np.float32(0.5) ** 2
    return 0.5 * ((m[None] * r2**-1.5)[..., None] * d).sum(1)


def _case(case):
    """(pos, mass, targets or None) of a case: n = 64, 300, 777 bodies, or
    targets a slice of 300 sources (the sharded path's use)."""
    if case == "rect":
        pos, mass = _rand(300, 1)
        return pos, mass, np.ascontiguousarray(pos[37:137])
    return (*_rand(int(case), int(case)), None)


CASES = ["64", "300", "777", "rect"]


@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_nbx(precision, case):
    pos, mass, tgt = _case(case)
    got = pairwise.pairwise_acc_reference(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5,
                                          None if tgt is None else torch.from_numpy(tgt), precision=precision,
                                          tile=128)
    assert _rel(got.numpy(), _nbx_acc(pos, mass, precision, tgt)) < NBX_BAR[precision]


SEPARATE_SEEDS = [2, 5, 9]


def _separate(seed, precision="mxu"):
    """`precision`'s plain version against `nbx`'s "mxu" on 100 targets
    apart from 300 sources."""
    pos, mass = _rand(300, seed)
    tgt, _ = _rand(100, seed + 100)
    got = pairwise.pairwise_acc_reference(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5,
                                          torch.from_numpy(tgt), precision=precision, tile=128)
    return _rel(got.numpy(), _nbx_mxu(f"separate {seed}")[0])


@pytest.mark.parametrize("seed", SEPARATE_SEEDS)
def test_mxu_without_self_pairs_matches_nbx(seed):
    """"mxu" where no self pair cancels: the plain version keeps to `nbx`
    to the order of its float32 sums."""
    assert _separate(seed) < MXU_SEPARATE_BAR


@functools.cache
def _nbx_mxu(case):
    """(`nbx`'s "mxu" on a case, the float64 sum, `nbx`'s error against it);
    case "separate <seed>" is `_separate`'s scene."""
    if case.startswith("separate"):
        seed = int(case.split()[1])
        (pos, mass), (tgt, _) = _rand(300, seed), _rand(100, seed + 100)
    else:
        pos, mass, tgt = _case(case)
    got, want = _nbx_acc(pos, mass, "mxu", tgt), _f64_acc(pos, mass, tgt)
    return got, want, _rel(got, want)


def _error_class(case, precision="mxu"):
    """The port's plain version of `precision` on a case: (its error
    against `nbx`'s "mxu", its error against float64 over `nbx`'s)."""
    pos, mass, tgt = _case(case)
    nbx, want, nbx_err = _nbx_mxu(case)
    got = pairwise.pairwise_acc_reference(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5,
                                          None if tgt is None else torch.from_numpy(tgt), precision=precision,
                                          tile=128).numpy()
    return _rel(got, nbx), _rel(got, want) / nbx_err


@pytest.mark.parametrize("case", CASES)
def test_mxu_error_class_matches_nbx(case):
    """"mxu"'s error against a float64 sum is `nbx`'s: between 0.9x and 1.1x
    of it on each case (measured 0.985x to 1.020x)."""
    lo, hi = MXU_ERROR_CLASS
    assert lo < _error_class(case)[1] < hi


@pytest.mark.parametrize("stand_in", ["f32r", "f32", "fast", "hyb", "bf16"])
def test_mxu_checks_reject_other_formulations(stand_in):
    """Control of the "mxu" checks above: another precision's plain version
    in "mxu"'s place misses `nbx`'s "mxu" by more than its bar on every case
    and on some separate-target scene, and leaves `nbx`'s error class on
    some case, on every case where it splits nothing into bf16 ("f32r",
    "f32", "hyb": well below it)."""
    lo, hi = MXU_ERROR_CLASS
    errs, ratios = zip(*(_error_class(case, stand_in) for case in CASES))
    assert min(errs) > NBX_BAR["mxu"]
    assert max(_separate(seed, stand_in) for seed in SEPARATE_SEEDS) > MXU_SEPARATE_BAR
    inside = [lo < r < hi for r in ratios]
    assert not (any(inside) if stand_in in ("f32r", "f32", "hyb") else all(inside))


def test_fma_rounds_once():
    """The plain version's fused multiply-add rounds a b + c once: just above,
    just below and at a float32 midpoint (a b = 1 + 2^-11 + 2^-24)."""
    a = torch.full((3,), 1 + 2**-12)
    got = pairwise._fma(a, a, torch.tensor([2**-60, -(2**-60), 0.0])).double()
    assert ((got - 1) * 2**23).tolist() == [4097.0, 4096.0, 4096.0]


def _tied(gen, shape):
    """1 + j 2^-12 for odd j < 2^10: the product of two is 1 + (i + j) 2^-12
    + i j 2^-24, a float32 midpoint, so that adding a tiny c rounds twice
    through float64."""
    return 1 + (torch.randint(0, 2**9, shape, generator=gen) * 2 + 1).float() * 2.0**-12


def _tiny(gen, shape):
    """+-k 2^e, e from -150 (float32's subnormals) to -40."""
    return (torch.randint(-8, 9, shape, generator=gen).float()
            * 2.0 ** torch.randint(-150, -40, shape, generator=gen).double()).float()


def test_fma_is_the_fma_rounded_to_odd():
    """`_fma` (the float64 sum, rounded to odd only where `_ties` finds a
    tie) is bitwise `_fma_odd` (rounded to odd everywhere): on random
    values, on products that tie plus a tiny c (rounded twice through
    float64 otherwise) and on sums below FLT_MIN."""
    gen = torch.Generator().manual_seed(0)
    n = 20_000
    for a, b, c in ((torch.randn(3, n, generator=gen) * 30).unbind(0),
                    (_tied(gen, (n,)), _tied(gen, (n,)), _tiny(gen, (n,))),
                    (_tiny(gen, (n,)) * 2.0**60, _tiny(gen, (n,)) * 2.0**30, _tiny(gen, (n,)))):
        assert torch.equal(pairwise._fma(a, b, c).view(torch.int32), pairwise._fma_odd(a, b, c).view(torch.int32))


@pytest.mark.parametrize("rows", [8, 1024])  # a small chain (runs of lanes checked at once) and a large one
def test_fma_lanes_is_fma_lane_by_lane(rows):
    """`_fma_lanes` is bitwise `_fma_odd` lane after lane, on products that
    tie, from a tiny start (so that the first lane rounds twice through
    float64 unless caught)."""
    gen = torch.Generator().manual_seed(rows)
    a, b = _tied(gen, (rows, 3, 128)), _tied(gen, (3, 128, 4))
    acc = want = _tiny(gen, (rows, 3, 4))
    for k in range(128):
        want = pairwise._fma_odd(a[..., k, None], b[:, k], want)
    assert torch.equal(pairwise._fma_lanes(a, b, acc).view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("precision", VARIANTS)
def test_error_ladder(precision):
    pos, mass = _rand(2048, seed=1)
    got = pairwise.pairwise_acc(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5, precision=precision)
    err = _rel(got.numpy(), _f64_acc(pos, mass))
    assert err < LADDER[precision]
    if precision == "bf16":
        assert err > 0, "bf16 identical to float64: the bf16 roundings are not happening"


@pytest.mark.parametrize("precision", VARIANTS)
def test_cpu_wrapper_runs_the_plain_version(precision):
    """On a CPU tensor the variant's wrapper is its plain version at the
    card's tile, and launches nothing."""
    pos, mass = (torch.from_numpy(x) for x in _rand(300, 3))
    wrapper = getattr(pairwise, f"pairwise_acc_{precision}")
    before = wrapper.launches
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, pos[10:50], precision)
    assert torch.equal(got, pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, pos[10:50], precision=precision))
    assert torch.equal(got, wrapper(pos, mass, 0.5, 0.5, pos[10:50]))
    assert wrapper.launches == before


def test_default_is_f32r_as_before():
    """The default precision is "f32r", bitwise the sum the port computed
    before the switch existed."""
    pos, mass = (torch.from_numpy(x) for x in _rand(777, 4))
    d = pos[None, :, :] - pos[:, None, :]
    inv = torch.rsqrt((d * d).sum(-1) + 0.25)
    want = ((inv * inv * inv * mass[None, :])[:, :, None] * d).sum(1) * 0.5
    for got in (pairwise.pairwise_acc(pos, mass, 0.5, 0.5), pairwise.pairwise_acc(pos, mass, 0.5, 0.5, None, "f32r"),
                pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("fn", [pairwise.pairwise_acc, pairwise.pairwise_acc_reference])
def test_mxu_and_unknown_precisions_raise(fn):
    """Unknown precisions raise ValueError; "mxu", which raised until K1c was
    ported, runs."""
    pos, mass = (torch.from_numpy(x) for x in _rand(64, 5))
    for bad in ("tf32", "f16"):
        with pytest.raises(ValueError, match="precision"):
            fn(pos, mass, 0.5, 0.5, precision=bad)
    assert torch.isfinite(fn(pos, mass, 0.5, 0.5, precision="mxu")).all()


@pytest.mark.parametrize("precision", VARIANTS)
def test_drift_run_matches_nbx(precision):
    """`tests/test_bench.py`'s Plummer sphere (N = 128), 200 compensated KDK
    steps, energies every 100."""
    sc = jscene.plummer(n=128, total_mass=128.0, scale_radius=5.0, seed=1)
    args = tuple(jnp.asarray(sc[k]) for k in ("pos", "vel", "mass")) + (1.0, 1.0, 1e-3)
    run = jdrift.drift_run.lower(*args, 200, 100, precision, True).compile(NO_EXCESS)
    want = [np.asarray(x) for x in run(*args)]
    got = drift.drift_run(*(torch.from_numpy(sc[k]) for k in ("pos", "vel", "mass")), 1.0, 1.0, 1e-3, 200, 100,
                          precision)
    assert got[2].shape == (3,)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < DRIFT_TOL
    assert drift.relative_drift(got[2]) < drift.GATE


def test_bench_mains_take_precisions_on_the_cpu(capsys):
    """`bench throughput` runs a comma list of precisions, one JSON line
    each; `bench drift` and the latency of one step take one."""
    rate = throughput.main(n=256, reps=2, precision="f32r,f32,fast,hyb,bf16,mxu", device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["precision"] for r in lines] == ["f32r", "f32", "fast", "hyb", "bf16", "mxu"]
    assert rate == lines[-1]["value"] > 0 and all(r["device"] == "cpu" for r in lines)
    for p in VARIANTS:
        assert latency.step_latency_ms(64, 2, precision=p, device="cpu") > 0
    r = drift.main(n=128, n_steps=100, precision="bf16", diag_every=50, device="cpu")
    assert r["precision"] == "bf16" and r["pass"] and r["device"] == "cpu"


@pytest.mark.parametrize("main", [throughput.main, drift.main])
def test_bench_mains_refuse_mxu_first(main, capsys):
    """An unknown precision raises before anything runs, also at the end of
    a list. ("mxu" raised so until K1c was ported.)"""
    with pytest.raises(ValueError, match="precision"):
        main(128, 10, "f32r,tf32" if main is throughput.main else "tf32", device="cpu")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("which", ["drift", "throughput"])
def test_cli_with_a_precision_raises_without_a_card(monkeypatch, which):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"drift": ["128", "100", "bf16"], "throughput": ["128", "2", "f32r,fast,hyb"]}[which]
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", which, *args])
