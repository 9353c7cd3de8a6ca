"""The port's reproduction pipelines (``nbdt_torch/scripts/``) against the JAX
package's (``scripts/``): each ``.sh`` runs under bash with a stub ``python``
first on ``PATH`` that only records its arguments, so nothing is trained.
The two recorded command lists match step for step once the package name
is swapped (and the baseline checkpoint's extension: the port's trainer
writes a ``.pth`` where JAX's writes a ``.msgpack``); every ``-m
nbdt_torch...`` command parses with its module's own parser, to the values
JAX's parser gives its twin. The ``.ps1`` twins are not run (no PowerShell
here): each names the same modules and flags, in the same order, as its
``.sh``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPTS = REPO / "scripts"
PORT_SCRIPTS = REPO / "nbdt_torch" / "scripts"
NAMES = ("gen_train_eval_resnet", "gen_train_eval_wideresnet", "gen_train_eval_pretrained",
         "gen_train_eval_nopretrained", "generate_hierarchies_wordnet")
# Commands each pipeline issues: 3 datasets x (hierarchy, train, 2 evals);
# 1 x the same; the baseline, then those 4; install + 2 wnids + 3 hierarchies
N_COMMANDS = {"gen_train_eval_resnet": 12, "gen_train_eval_wideresnet": 12,
              "gen_train_eval_pretrained": 4, "gen_train_eval_nopretrained": 5,
              "generate_hierarchies_wordnet": 6}


def parsers(package: str) -> dict:
    """{module: its CLI's parser factory} of one package."""
    import importlib

    return {f"{package}.{mod}": importlib.import_module(f"{package}.{mod}").get_parser
            for mod in ("main", "bin.nbdt_hierarchy", "bin.nbdt_wnids")
            if package == "nbdt_torch" or mod != "bin.nbdt_wnids"}


def recorded(script: Path, tmp: Path) -> list:
    """The argument lists of every ``python`` the script runs, in order."""
    stub = tmp / "stub"
    stub.mkdir(exist_ok=True)
    (stub / "python").write_text(
        f"#!{sys.executable}\nimport json, os, sys\n"
        "with open(os.environ['STUB_LOG'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    (stub / "python").chmod(0o755)
    log = tmp / f"{script.parent.parent.name}-{script.stem}.jsonl"
    env = {**os.environ, "PATH": f"{stub}{os.pathsep}{os.environ['PATH']}", "STUB_LOG": str(log)}
    proc = subprocess.run(["bash", str(script)], cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


def as_port(cmd: list) -> list:
    return [a.replace("nbdt_tpu", "nbdt_torch").replace(".msgpack", ".pth") for a in cmd]


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """{name: (JAX's recorded commands, the port's)}."""
    tmp = tmp_path_factory.mktemp("scripts")
    return {name: (recorded(JAX_SCRIPTS / f"{name}.sh", tmp),
                   recorded(PORT_SCRIPTS / f"{name}.sh", tmp)) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_port_script_issues_the_jax_commands(commands, name):
    jax_cmds, port_cmds = commands[name]
    assert len(port_cmds) == len(jax_cmds) == N_COMMANDS[name]
    for i, (j, p) in enumerate(zip(jax_cmds, port_cmds)):
        assert p == as_port(j), f"step {i}: {p} != {j}"
        assert not any("nbdt_tpu" in a for a in p)
        assert p[0] in ("-m", "-c") and (p[0] == "-c" or p[1].startswith("nbdt_torch."))


@pytest.mark.parametrize("name", NAMES)
def test_port_commands_parse_as_jax_commands_do(commands, name):
    """Each ``-m`` command parses with the port module's parser, and every
    option both parsers have gets the value JAX's parser gives the JAX
    command (``.pth`` and ``pth`` for JAX's ``.msgpack`` and ``msgpack``, the
    checkpoint format of each trainer); the port's CLIs keep their CUDA
    default. The ``-c`` step
    imports the port's ``maybe_install_wordnet`` and runs it (it never
    downloads)."""
    port_parsers, jax_parsers = parsers("nbdt_torch"), parsers("nbdt_tpu")
    for j, p in zip(*commands[name]):
        if p[0] == "-c":
            assert "from nbdt_torch.hierarchy.wnid import maybe_install_wordnet" in p[1]
            exec(compile(p[1], "<script -c>", "exec"), {})
            continue
        try:
            got = vars(port_parsers[p[1]]().parse_args(p[2:]))
        except SystemExit:
            pytest.fail(f"{p[1]}'s parser refused {p[2:]}")
        if "device" in got:
            assert got["device"] == "cuda"
        if j[1] not in jax_parsers:  # nbdt_wnids: JAX's builds its parser inside main
            continue
        want = vars(jax_parsers[j[1]]().parse_args(j[2:]))
        for key in sorted(set(got) & set(want)):
            value = want[key]
            if isinstance(value, str):  # each trainer's checkpoint format
                value = value.replace(".msgpack", ".pth").replace("msgpack", "pth")
            assert got[key] == value, (p, key)


def script_commands(path: Path) -> list:
    """(``-m`` module or ``-c``, the sorted flag names) of each ``python``
    line of a .sh or .ps1, in the order of the text; bash's continued lines
    joined."""
    out = []
    for line in path.read_text().replace("\\\n", " ").splitlines():
        tokens = line.split()
        if not tokens or tokens[0] != "python":
            continue
        target = tokens[2] if tokens[1] == "-m" else tokens[1]
        out.append((target, sorted(t.split("=")[0] for t in tokens if t.startswith("--"))))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_ps1_names_the_modules_and_flags_of_its_sh(name):
    sh = script_commands(PORT_SCRIPTS / f"{name}.sh")
    ps1 = script_commands(PORT_SCRIPTS / f"{name}.ps1")
    assert sh and ps1 == sh
    assert all(t == "-c" or t.startswith("nbdt_torch.") for t, _ in ps1)
    assert "nbdt_tpu" not in (PORT_SCRIPTS / f"{name}.ps1").read_text()


def test_scripts_are_package_data():
    """setup.py ships every script of the port beside its CUDA sources."""
    text = (REPO / "setup.py").read_text()
    assert '"scripts/*.sh", "scripts/*.ps1"' in text
    assert sorted(p.name for p in PORT_SCRIPTS.iterdir()) == sorted(
        f"{n}.{ext}" for n in NAMES for ext in ("sh", "ps1"))
    assert sorted(p.name for p in JAX_SCRIPTS.iterdir()) == sorted(
        p.name for p in PORT_SCRIPTS.iterdir())
