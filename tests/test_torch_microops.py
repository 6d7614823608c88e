"""nbx_torch.bench.microops against nbx.bench.microops on the CPU: each
variant gives the JAX function's result bitwise, the two forms of each
primitive agree (the kill pair where partners are mutual), the device-side
rotation is np.roll, the chained loop is the JAX loop, and the main prints
one JSON line a variant. The CLI refuses to run the probe without a card."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.bench import microops as jmicro
from nbx_torch import __main__ as cli
from nbx_torch.bench import microops

torch.set_num_threads(1)

N = 4096
# fewer and more set rows than the extraction cap K = 256
DENSITIES = (0.01, 0.2)
PAIRS = {
    "take_scatter": jmicro._take_rows_scatter,
    "take_search": jmicro._take_rows_searchsorted,
    "kill_scatter": jmicro._kill_scatter,
    "kill_arith": jmicro._kill_arith,
    "inv_scatter": jmicro._inv_scatter,
    "inv_argsort": jmicro._inv_argsort,
}


def _inputs(density, seed=1):
    rng = np.random.default_rng(seed)
    mask = rng.random(N) < density
    partner = rng.integers(0, N, N, dtype=np.int32)
    order = rng.permutation(N).astype(np.int32)
    return mask, partner, order


def _call(variant, fn, mask, partner, order, conv):
    if variant.startswith("take"):
        return fn(conv(mask), microops.K)
    if variant.startswith("kill"):
        return fn(conv(mask), conv(partner))
    return fn(conv(order))


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("variant", microops.VARIANTS)
def test_variant_is_the_jax_function_bitwise(variant, density):
    mask, partner, order = _inputs(density)
    assert (mask.sum() > microops.K) == (density > 0.1)
    want = _as_list(_call(variant, PAIRS[variant], mask, partner, order, jnp.asarray))
    got = _as_list(_call(variant, getattr(microops, variant), mask, partner, order, torch.from_numpy))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("density", DENSITIES)
def test_take_forms_agree(density):
    mask = torch.from_numpy(_inputs(density)[0])
    for a, b in zip(microops.take_scatter(mask, microops.K), microops.take_search(mask, microops.K)):
        assert torch.equal(a, b)


def test_inverse_forms_agree():
    order = torch.from_numpy(_inputs(0.01)[2])
    inv = microops.inv_scatter(order)
    assert torch.equal(inv, microops.inv_argsort(order))
    assert torch.equal(inv[order.long()], torch.arange(N, dtype=torch.int32))


def test_kill_forms_agree_on_mutual_partners():
    mask, partner = microops.mutual_input(N, "cpu")
    assert torch.equal(partner[partner.long()], torch.arange(N, dtype=torch.int32))
    kill = microops.kill_scatter(mask, partner)
    assert int(kill.sum()) == int(mask.sum()) // 2 > 0
    assert torch.equal(kill, microops.kill_arith(mask, partner))


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 6, -5, N + 7])
def test_device_roll_is_np_roll(shift):
    x = torch.arange(N, dtype=torch.int32)
    got = microops.roll(x, torch.tensor(shift))
    np.testing.assert_array_equal(got.numpy(), np.roll(np.arange(N, dtype=np.int32), shift))


@pytest.mark.parametrize("variant", microops.VARIANTS)
def test_chain_is_the_jax_loop(variant):
    """A few chained iterations give the JAX loop's running sum (no int32
    wrap at this size)."""
    mask0, partner, order = microops.probe_inputs(N, "cpu")
    want = int(jmicro._loop(*(jnp.asarray(x.numpy()) for x in (mask0, partner, order)), variant, 4, N))
    assert int(microops.chain(mask0, partner, order, variant, 4)) == want


def test_main_prints_a_line_a_variant(capsys, monkeypatch):
    monkeypatch.setattr(microops, "STEPS", 3)
    rows = microops.main(N, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == rows
    assert [r["variant"] for r in rows] == list(microops.VARIANTS)
    for r in rows:
        assert set(r) == {"n", "variant", "us_per_op", "graph_us_per_op", "device"}
        assert r["n"] == N and r["device"] == "cpu" and r["us_per_op"] > 0 and r["graph_us_per_op"] is None


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", "microops", "4096"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        microops.main(4096)
