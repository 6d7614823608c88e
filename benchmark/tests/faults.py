"""Faults planted under the timed path, for the tests that show `correct`
comes out false on each (`--patch benchmark.tests.faults:<name>`).

Each replaces a function of the program in the process it runs in, before
the configuration's set-up, so that the cells' entries run broken."""

from __future__ import annotations

BODY = 5  # the body whose answer `altered_answer` changes


def unchanged_state() -> None:
    """A step that returns its state unchanged."""
    from nbx_torch import sim
    from nbx_torch.parallel import shard

    sim.step = lambda state, cfg, *args, **kwargs: (state, None)
    shard.make_sharded_step = lambda mesh, impl="auto": (lambda state, G, eps, h: state)


def half_sources() -> None:
    """Half the bodies left out of the force, the other half's masses
    doubled: the mean taken over the rest."""
    from nbx_torch import sim
    from nbx_torch.ops import pairwise
    from nbx_torch.parallel import shard

    whole = pairwise.pairwise_acc

    def half(pos, mass, G, softening, target_pos=None):
        return whole(pos[::2].contiguous(), 2.0 * mass[::2], G, softening,
                     target_pos=pos if target_pos is None else target_pos)

    sim.gravity = lambda pos, mass, G, softening, impl="auto": half(pos, mass, G, softening)
    shard.pairwise_acc = half


def no_exchange() -> None:
    """The all-gather left out: each rank sums its own rows' force alone."""
    from nbx_torch.parallel import shard

    shard._gather = lambda ax, *fields: list(fields)


def altered_answer() -> None:
    """One body's acceleration off by 10% where the force is produced."""
    from nbx_torch import sim
    from nbx_torch.parallel import shard

    def altered(fn):
        def wrapped(*args, **kwargs):
            acc = fn(*args, **kwargs).clone()
            acc[BODY] *= 1.1
            return acc
        return wrapped

    sim.gravity = altered(sim.gravity)
    shard._local_acc = altered(shard._local_acc)


def forbidden_import_in_judge() -> None:
    """JAX loaded once the window has closed: the reference, which every
    judge calls, puts a module named `jax` into sys.modules."""
    import sys
    import types

    from benchmark.reference import gravity

    follow = gravity.kdk

    def kdk(*args, **kwargs):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return follow(*args, **kwargs)

    gravity.kdk = kdk
