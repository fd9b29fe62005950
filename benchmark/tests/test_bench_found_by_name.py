"""What belongs to one configuration or one traffic mix is found by name:
the geometry by ``TestType``, the monitor by ``Dim`` and ``MonType``, the
reference's steps by the traffic's ``reference``; a name with no file is
refused with the name in the message."""

import json
import os

import pytest

from benchmark.cells import HERE
from benchmark.reference import geometry, monitors, steps

TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "traffic")) if f.endswith(".json"))


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_traffic_names_its_steps(traffic):
    with open(os.path.join(HERE, "traffic", f"{traffic}.json")) as f:
        mod = steps.load(json.load(f)["reference"])
    for fn in ("build", "start", "step", "resume"):
        assert callable(getattr(mod, fn)), fn


def test_unknown_names_are_refused():
    with pytest.raises(ValueError, match="Spiral"):
        geometry.geometry({"TestType": "Spiral", "Dim": 3})
    with pytest.raises(ValueError, match="monitor 9"):
        monitors.get_monitor(3, 9)
    with pytest.raises(ModuleNotFoundError):
        steps.load("no_such_method")
