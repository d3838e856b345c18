"""The traffic generators: the same seed gives the same calls, another seed
other calls of the same sizes."""

import importlib
import itertools
import json
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (PB / "traffic").glob("*.json"))


def _calls(mix, seed, n=6):
    tr = json.loads((PB / "traffic" / f"{mix}.json").read_text())
    drv = importlib.import_module(f"perfbench.drivers.{tr['entry']}")
    return list(itertools.islice(drv.requests(tr, seed), n))


def _shape(call):
    return {k: (len(v), [len(x) if isinstance(x, list) else 1 for x in v])
            if isinstance(v, list) else type(v).__name__ for k, v in call.items() if k != "i"}


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_calls(mix):
    seed = 2**31 + 12345
    assert _calls(mix, seed) == _calls(mix, seed)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_calls_of_the_same_sizes(mix):
    a, b = _calls(mix, 7), _calls(mix, 8)
    assert a != b
    assert [_shape(c) for c in a] == [_shape(c) for c in b]


def test_synthetic_images_are_seeded():
    from perfbench.drivers.encode import synthetic_images

    a, b = synthetic_images(5, 2, 32, 48), synthetic_images(5, 2, 32, 48)
    assert all((x == y).all() for x, y in zip(a, b))
    assert a[0].shape == (32, 48, 3) and a[0].dtype.name == "uint8"
    assert not (synthetic_images(6, 1, 32, 48)[0] == a[0]).all()
