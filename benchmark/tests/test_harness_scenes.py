"""The frozen scene copies: fixed digests, and the same bits as the port's
generators they were copied from."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark import scenes

DIGESTS = {
    ("cold_collapse_disk", (4096,), (("seed", 0),)): "f3be516dd14c1e581d4e58e10620ee43",
    ("cold_collapse_disk", (1000, 50.0, 10.0), (("seed", 2**31 + 5),)): "ea0a7b592e877bb181b96b12d9a8738d",
    ("galaxy_merger", (4096,), (("separation", 260.0), ("approach_speed", 0.8), ("seed", 0))):
        "78c3ce3746e34537f7720137692fc161",
    ("galaxy_merger", (1001,), (("seed", 2**31 + 5),)): "0edd2f3d118fd172955e26a3b112f76e",
}


def digest(sc: dict) -> str:
    h = hashlib.sha256()
    for k in ("pos", "vel", "mass", "mat", "temp"):
        h.update(np.ascontiguousarray(sc[k]).tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("key", list(DIGESTS), ids=lambda k: f"{k[0]}-{k[1][0]}-{dict(k[2])['seed']}")
def test_frozen_digest(key):
    name, args, kwargs = key
    assert digest(getattr(scenes, name)(*args, **dict(kwargs))) == DIGESTS[key]


@pytest.mark.parametrize("key", list(DIGESTS), ids=lambda k: f"{k[0]}-{k[1][0]}-{dict(k[2])['seed']}")
def test_same_bits_as_the_port(key):
    from nbx_torch import scene

    name, args, kwargs = key
    ours, port = getattr(scenes, name)(*args, **dict(kwargs)), getattr(scene, name)(*args, **dict(kwargs))
    for k in ("pos", "vel", "mass", "mat", "temp"):
        assert ours[k].dtype == port[k].dtype and np.array_equal(ours[k], port[k])


def test_seeds_move_the_scene_and_large_seeds_work():
    a = scenes.cold_collapse_disk(256, seed=2**33 + 1)
    b = scenes.cold_collapse_disk(256, seed=2**33 + 2)
    assert not np.array_equal(a["pos"], b["pos"])
    assert a["pos"].shape == (256, 3) and a["mass"].sum() == pytest.approx(1000.0, rel=1e-5)
