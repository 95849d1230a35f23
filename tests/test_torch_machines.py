"""The port's bundled machine files (``src/repro_torch/machines/``): the
paper's Ivy Bridge files and the TPU v5e file are byte copies of the JAX
package's and load by JAX's aliases, each to the machine JAX's ``load``
gives; every machine a port message names loads; ``machine validate``
with no path checks all four files clean."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re

import pytest

pytest.importorskip("jax")

from repro.core import machine as j_machine  # noqa: E402
from repro.fleet import analyzer as j_fleet  # noqa: E402

from repro_torch import cli  # noqa: E402
from repro_torch.core import machine  # noqa: E402
from repro_torch.fleet import FleetAnalyzer, dump_configs  # noqa: E402
from repro_torch.fleet.analyzer import machine_label  # noqa: E402
from repro_torch.tune import calibrate  # noqa: E402
from _torch_machines import JAX_DIR, PORT_DIR, jax_side  # noqa: E402

PORT_SRC = pathlib.Path(machine.__file__).resolve().parents[1]
#: JAX's aliases and its files
JAX_ALIASES = {"IVY": "ivybridge_ep.yaml",
               "IVY122": "ivybridge_ep_sec122.yaml",
               "V5E": "tpu_v5e.yaml"}
#: how a port message names a machine: ``-m NAME`` (a command line, not
#: the usage lines' placeholder ``MACHINE``) or a description's example,
#: ``(e.g. NAME)``
NAMED = re.compile(r"-m (?!MACHINE\b)(?P<a>[A-Z][A-Z0-9]+)\b|"
                   r"machine description \(e\.g\. (?P<b>[A-Z][A-Z0-9]+)\)")


def _fields(m) -> dict:
    """A Machine as nested plain values, whichever package built it."""
    return json.loads(json.dumps(dataclasses.asdict(m), default=str))


def test_bundled_files_are_the_four():
    assert sorted(p.name for p in PORT_DIR.glob("*.yaml")) == sorted(
        list(JAX_ALIASES.values()) + ["h100_sxm.yaml"])
    assert machine.ALIASES == {**JAX_ALIASES, "H100": "h100_sxm.yaml"}


@pytest.mark.parametrize("name", sorted(JAX_ALIASES.values()))
def test_copies_are_jax_s_bytes(name):
    assert (PORT_DIR / name).read_bytes() == (JAX_DIR / name).read_bytes()
    assert jax_side(str(PORT_DIR / name)) == str(JAX_DIR / name)


def test_h100_file_is_the_port_s_own():
    """The card's file has no JAX counterpart: JAX's oracles read it from
    the port's tree, and it loads alike in both packages."""
    assert not (JAX_DIR / "h100_sxm.yaml").exists()
    path = str(PORT_DIR / "h100_sxm.yaml")
    assert jax_side(path) == path
    assert _fields(machine.load("H100")) == \
        _fields(j_machine.Machine.from_yaml(path))
    assert machine.load("H100").name.startswith("NVIDIA H100")


@pytest.mark.parametrize("alias", sorted(JAX_ALIASES))
def test_alias_loads_jax_s_machine(alias):
    """Each alias, upper or lower case, gives JAX's ``load(alias)`` field
    for field, with the same fingerprint, from the port's own file."""
    ours, theirs = machine.load(alias), j_machine.load(alias)
    assert _fields(ours) == _fields(theirs)
    assert ours.fingerprint == theirs.fingerprint
    assert machine.load(alias.lower()) == ours
    assert ours == machine.Machine.from_yaml(
        str(PORT_DIR / JAX_ALIASES[alias]))


@pytest.mark.parametrize("alias", sorted(machine.ALIASES))
def test_calibration_target_is_the_port_s_file(alias):
    """``--apply-calibration`` resolves an alias to the port's file, never
    to the JAX tree's."""
    assert calibrate.machine_yaml_path(alias) == \
        PORT_DIR / machine.ALIASES[alias]


def _named_machines() -> dict:
    """Every machine a port message names, with the files naming it."""
    found: dict[str, set] = {}
    for path in sorted(PORT_SRC.rglob("*.py")):
        for m in NAMED.finditer(path.read_text()):
            name = m.group("a") or m.group("b")
            found.setdefault(name, set()).add(
                str(path.relative_to(PORT_SRC)))
    return found


def test_machines_named_in_port_messages_load():
    """The X-rule's ``use -m V5E`` (``core/lint/rules_cross.py``), the
    ``hlo-roofline`` refusal's ``(e.g. V5E)`` (``core/model_api.py``) and
    the usage lines' ``-m H100``: each name resolves through
    ``machine.load``."""
    found = _named_machines()
    assert {"core/lint/rules_cross.py", "core/model_api.py"} <= \
        found.get("V5E", set()), found
    assert "H100" in found
    for name in found:
        assert machine.load(name) == machine.Machine.from_yaml(
            str(PORT_DIR / machine.ALIASES[name]))


def test_machine_validate_without_paths_checks_all_four(capsys):
    assert cli.main(["machine", "validate"]) == 0
    out = capsys.readouterr().out
    for name in machine.ALIASES.values():
        assert f"lint: {name}: no findings" in out, out
    assert "error" not in out
    assert cli.main(["machine", "validate", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert sorted(r["file"] for r in report) == sorted(
        machine.ALIASES.values())
    assert all(r["errors"] == 0 for r in report)


@pytest.mark.parametrize("alias", ["IVY", "V5E"])
def test_fleet_by_alias_equals_jax_s(alias):
    """The goldens' machines by alias: the port's fleet report of a
    bundled dump equals JAX's by the same alias, under the same label."""
    cfg = dump_configs()[0]
    ours = FleetAnalyzer().analyze(cfg, alias)
    assert ours.to_dict() == j_fleet.FleetAnalyzer().analyze(
        cfg, alias).to_dict()
    assert machine_label(alias) == j_fleet.machine_label(alias) == \
        JAX_ALIASES[alias][:-len(".yaml")]
