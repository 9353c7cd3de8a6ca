"""nbdt_torch.examples.train_imagenet against examples/imagenet/train.py.

The JAX example is a script: it is loaded by file path, unedited. The port's
``main`` runs on the CPU from JAX's initial weights: the test replaces the
example's ``init_model`` with one that loads them through
``state_dict_from_flax`` (the package is left as it is).

The tiny config: ResNet10, 8 classes (so that JAX's ``--tp 2`` divides
them), 16px, global batch 16 (the conftest gives JAX 8 CPU devices: dp=8,
or dp=4 tp=2), SoftTreeSupLoss with tsw=5 on a hierarchy that is not
vendored for Imagenet1000, so both packages induce the tree from the
classifier rows; a warmup of 1 step and a decay at epoch 1. The schedule's
peak is 0.01: the example feeds unnormalized 0-255 pixels, and at the
reference's 0.4 the first steps' f32 rounding differences grow past the
printed 4 decimals within 3 steps. Even at 0.01 JAX's own ``--tp 2`` run
prints a last loss 6e-4 from its ``--tp 1`` run (the classifier and tree
products contract in other orders); so the port is held to JAX's tp=1 line
within 1e-4 and to its tp=2 line no farther than JAX's two runs are apart,
plus 1e-4.

Two worker processes form one gloo group through a ``file://`` store and
run the port's ``main`` twice: at ``--tp 2`` (dp=1, the classifier's 8
classes split 4 and 4) and at ``--tp 1`` (dp=2, 8 rows a rank). Each is
held to the one-process port and to JAX's epoch lines.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {name: os.path.join(REPO, "examples", "imagenet", "configs", f"{name}-nbdt.json")
           for name in ("resnet18", "resnet50", "efficientnet_b7b")}
ARCH, C, IMG, BATCH = "ResNet10", 8, 16, 16
TINY = {
    "num_epochs": 2, "batch_size": BATCH,
    "loss": {"name": "SoftTreeSupLoss", "tree_supervision_weight": 5.0,
             "hierarchy": "induced-ResNet10"},
    "model": {"arch": ARCH, "num_classes": C, "image_size": IMG},
    "optimizer": {"momentum": 0.9, "weight_decay": 1e-4,
                  "lr": {"warmup_frac": 0.3, "start_value": 0.0025, "end_value": 0.01,
                         "values": [0.01, 0.001], "milestones": [1]}},
}
LINE = re.compile(r"epoch (\d+): loss=([\d.]+) top1=([\d.]+)% top5=([\d.]+)%")
DEADLINE = 300  # seconds for the pair; a rank that dies kills its sibling


@functools.lru_cache(maxsize=None)
def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_imagenet_train", os.path.join(REPO, "examples", "imagenet", "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX example's own init: ``init_model`` at the default seed."""
    from nbdt_tpu.models import init_model

    return init_model(ARCH, C, (IMG, IMG, 3))


def _init_state() -> dict:
    import jax

    from nbdt_torch.models import state_dict_from_flax

    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, _jax_init()[1]), ARCH)


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """The JAX example's fallback tree, from JAX's own pieces."""
    from nbdt_tpu.assets import get_dataset_wnids
    from nbdt_tpu.hierarchy.build import build_induced_graph
    from nbdt_tpu.hierarchy.generate import get_centers_from_flax_params
    from nbdt_tpu.tree import Tree

    wnids = get_dataset_wnids("Imagenet1000")[:C]
    G = build_induced_graph(wnids, get_centers_from_flax_params(_jax_init()[1]["params"]))
    return Tree.from_graph(G, wnids, classes=[f"class{i}" for i in range(C)])


def _lines(text: str) -> list:
    return [tuple(float(v) for v in m.groups()) for m in LINE.finditer(text)]


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture(scope="module")
def jax_run(tiny_config):
    """JAX's example at ``--tp 1`` and ``--tp 2``: the printed text of each."""
    out = {}
    for tp in ("1", "2"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _jax_example().main(["--config", tiny_config, "--synthetic", "--platform", "cpu",
                                 "--tp", tp])
        out[tp] = buf.getvalue()
    return out


@pytest.fixture(scope="module")
def port_run(tiny_config):
    """The port's ``main`` on JAX's weights, one process on the CPU: its
    printed lines, its return value and the state after its first step."""
    from nbdt_torch.examples import train_imagenet
    from nbdt_torch.models import get_model

    state = _init_state()
    first = {}

    def init_model(arch, num_classes, input_shape, seed=0, dtype=torch.float32, device="cuda"):
        model = get_model(arch, num_classes)
        model.load_state_dict(state)
        return model.to(device, memory_format=torch.channels_last).eval()

    original = train_imagenet.make_train_step

    def make_train_step(model, *args, **kw):
        step = original(model, *args, **kw)

        def recorded(*a):
            m = step(*a)
            if not first:
                first.update({k: v.detach().clone() for k, v in model.state_dict().items()})
            return m

        return recorded

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(train_imagenet, "init_model", init_model)
        mp.setattr(train_imagenet, "make_train_step", make_train_step)
        out = train_imagenet.main(["--config", tiny_config, "--synthetic", "--device", "cpu"])
    return buf.getvalue(), out, first


# --- the schedule -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_matches_optax_at_every_step(name):
    """90 epochs of 5005 steps (ImageNet at batch 256): every step, so every
    milestone boundary -1, 0, +1 and the whole warmup, rtol 1e-6."""
    import jax.numpy as jnp

    from nbdt_torch.examples.train_imagenet import build_lr_schedule

    opt = json.load(open(CONFIGS[name]))["optimizer"]
    spe, epochs = 5005, 90
    want = np.asarray(_jax_example().build_lr_schedule(opt, spe, epochs)(
        jnp.arange(spe * epochs)))
    lr_at = build_lr_schedule(opt, spe, epochs)
    got = np.array([lr_at(i) for i in range(spe * epochs)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    warmup = int(spe * epochs * opt["lr"]["warmup_frac"])
    values = opt["lr"]["values"]
    for i, m in enumerate(opt["lr"]["milestones"]):  # each decay fires at its epoch's first step
        np.testing.assert_allclose(got[m * spe - 1:m * spe + 2],
                                   [values[i], values[i + 1], values[i + 1]], rtol=1e-6)
    np.testing.assert_allclose(got[[0, warmup - 1, warmup]],
                               [opt["lr"]["start_value"], want[warmup - 1], values[0]],
                               rtol=1e-6)


@pytest.mark.parametrize("spe,epochs", [(2, 2), (1, 3), (7, 40), (2, 90)])
def test_schedule_matches_optax_on_short_runs(spe, epochs):
    """A 1-step warmup and milestones a step past it, as the smoke run's."""
    import jax.numpy as jnp

    from nbdt_torch.examples.train_imagenet import build_lr_schedule

    for opt in (TINY["optimizer"], json.load(open(CONFIGS["resnet18"]))["optimizer"]):
        n = spe * epochs + 3
        if min(opt["lr"]["milestones"]) * spe <= max(1, int(spe * epochs
                                                           * opt["lr"]["warmup_frac"])):
            continue
        want = np.asarray(_jax_example().build_lr_schedule(opt, spe, epochs)(jnp.arange(n)))
        lr_at = build_lr_schedule(opt, spe, epochs)
        np.testing.assert_allclose([lr_at(i) for i in range(n)], want, rtol=1e-6)


def test_milestone_inside_warmup_raises_as_jax():
    from nbdt_torch.examples.train_imagenet import build_lr_schedule

    opt = {"lr": {"warmup_frac": 0.2, "milestones": [1, 5, 30]}}
    errors = []
    for fn in (_jax_example().build_lr_schedule, build_lr_schedule):
        with pytest.raises(ValueError) as e:
            fn(opt, 10, 10)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "[1]" in errors[1] and "20 steps ~= 2.0 epochs" in errors[1]


# --- the training run -------------------------------------------------------


def test_epoch_lines_match_jax(jax_run, port_run):
    """The last step's loss within 1e-4 of JAX's printed 4 decimals; top-1
    and top-5 equal (no test row's top-5 boundary lies within 1e-4)."""
    text, out, _ = port_run
    want, got = _lines(jax_run["1"]), _lines(text)
    assert "mesh: dp=8 tp=1" in jax_run["1"] and "mesh: dp=1 tp=1" in text
    assert len(want) == len(got) == TINY["num_epochs"]
    for (e, loss, top1, top5), (e2, _, top1b, top5b), rec in zip(want, got, out["epochs"]):
        assert e == e2
        assert abs(rec["loss"] - loss) <= 1e-4, (rec["loss"], loss)
        assert (top1b, top5b) == (top1, top5)
    assert len(out["step_losses"]) == 4 and np.isfinite(out["step_losses"]).all()


def test_induced_tree_matches_jax(port_run):
    """Below 1000 classes, with no vendored graph under the config's name,
    both packages induce the tree from the same classifier rows over the
    first C Imagenet1000 wnids."""
    want, got = _jax_tree(), port_run[1]["tree"]
    assert sorted(got.G.nodes) == sorted(want.G.nodes)
    assert got.wnids_leaves == want.wnids_leaves and got.classes == want.classes
    for field, value in vars(want.arrays).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(got.arrays, field), value, err_msg=field)


def test_learning_rates_are_the_schedules(port_run):
    import jax.numpy as jnp

    lrs = port_run[1]["lrs"]
    sched = _jax_example().build_lr_schedule(TINY["optimizer"], 2, TINY["num_epochs"])
    np.testing.assert_allclose(lrs, np.asarray(sched(jnp.arange(len(lrs)))), rtol=1e-6)
    np.testing.assert_allclose(lrs, [0.0025, 0.01, 0.001, 0.001], rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_first_step(dtype):
    """The example's first step rebuilt from JAX's own pieces (its
    ``build_lr_schedule``, the optax chain, ``soft_tree_sup_loss`` on the
    induced tree, the module at ``dtype``) on the loader's first batch:
    (loss, the port's state dict of the variables after the step)."""
    import jax
    import optax

    from nbdt_tpu.data import DataLoader, SyntheticDataset
    from nbdt_tpu.losses import cross_entropy, soft_tree_sup_loss
    from nbdt_tpu.models import get_model
    from nbdt_tpu.rules import to_device_tree

    from nbdt_torch.models import state_dict_from_flax

    module, variables = get_model(ARCH, C, dtype=dtype), _jax_init()[1]
    jt = to_device_tree(_jax_tree().arrays)
    x, y, _ = next(iter(DataLoader(SyntheticDataset(C, size=2 * BATCH, image_size=IMG),
                                   batch_size=BATCH, shuffle=True)))
    opt = TINY["optimizer"]
    optimizer = optax.chain(optax.add_decayed_weights(opt["weight_decay"]),
                            optax.trace(decay=opt["momentum"]),
                            optax.scale_by_learning_rate(
                                _jax_example().build_lr_schedule(opt, 2, 2)))

    def loss_fn(p):
        logits, mutated = module.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                       x, train=True, mutable=["batch_stats"])
        loss = cross_entropy(logits, y) + 5.0 * soft_tree_sup_loss(logits, y, jt)
        return loss, mutated["batch_stats"]

    params = variables["params"]
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    after = {"params": optax.apply_updates(params, updates), "batch_stats": stats}
    return float(loss), state_dict_from_flax(jax.tree_util.tree_map(np.asarray, after), ARCH)


def _expected_state(want: dict) -> dict:
    """JAX's state after one step with each running variance mapped from
    flax's biased update to torch's unbiased one."""
    init, counts, out = _init_state(), _bn_counts(), {}
    for k, w in want.items():
        if k.endswith("running_var"):
            n = counts[k[: -len(".running_var")]]
            w = 0.9 * init[k] + n / (n - 1) * (w - 0.9 * init[k])
        out[k] = w
    return out


def test_first_step_matches_jax_pieces(port_run):
    """The port's first step against :func:`_jax_first_step` in f32: the
    loss within rtol 1e-5, every parameter and statistic within rtol 2e-4 /
    atol 2e-5, as test_torch_train holds the trainer (the running
    statistics of raw 0-255 pixels reach the hundreds)."""
    import jax.numpy as jnp

    _, out, first = port_run
    loss, want = _jax_first_step(jnp.float32)
    np.testing.assert_allclose(out["step_losses"][0], loss, rtol=1e-5)
    for k, w in _expected_state(want).items():
        torch.testing.assert_close(first[k], w, rtol=2e-4, atol=2e-5, msg=k)


def test_bf16_first_step_matches_jax_pieces(tiny_config):
    """``--bf16``: the backbone under bf16 autocast with f32 parameters
    against JAX's ``init_model(dtype=bfloat16)`` (bf16 convs, f32
    parameters and losses), both from one init. The first step's loss
    within ``assert_close``'s bf16 tolerances (rtol 1.6e-2, atol 1e-5).
    The step's update (every parameter's change) no farther from JAX's
    bf16 update, in L2 over the whole model, than twice JAX's own bf16
    update is from its f32 one: one bf16 step on raw 0-255 pixels moves
    the update by 15% (measured: JAX 0.147, the port 0.174, the port from
    JAX 0.174), so no entry-wise bf16 tolerance holds for entries that are
    the update alone (a bias after one step)."""
    import jax.numpy as jnp

    from nbdt_torch.examples import train_imagenet
    from nbdt_torch.models import get_model

    state, first = _init_state(), {}

    def init_model(arch, num_classes, input_shape, seed=0, dtype=torch.float32, device="cuda"):
        model = get_model(arch, num_classes)
        model.load_state_dict(state)
        return model.eval()

    original = train_imagenet.make_train_step

    def make_train_step(model, *args, **kw):
        step = original(model, *args, **kw)

        def recorded(*a):
            m = step(*a)
            first.setdefault("state", {k: v.detach().clone()
                                       for k, v in model.state_dict().items()})
            return m

        return recorded

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_imagenet, "init_model", init_model)
        mp.setattr(train_imagenet, "make_train_step", make_train_step)
        out = train_imagenet.main(["--config", tiny_config, "--synthetic", "--device", "cpu",
                                   "--bf16", "--epochs", "1"])
    loss, want = _jax_first_step(jnp.bfloat16)
    torch.testing.assert_close(torch.tensor(out["step_losses"][0]), torch.tensor(loss),
                               rtol=1.6e-2, atol=1e-5)
    init, f32 = _init_state(), _jax_first_step(jnp.float32)[1]

    def distance(a, b):
        """||a - b|| / ||b - init|| over the parameters (no statistics)."""
        keys = [k for k in b if not k.endswith(("running_mean", "running_var"))]
        num = sum(float(((a[k].float() - b[k]) ** 2).sum()) for k in keys)
        return (num / sum(float(((b[k] - init[k]) ** 2).sum()) for k in keys)) ** 0.5

    own = distance(f32, want)
    assert 0 < own < 0.3 and distance(first["state"], want) <= 2 * own


def _bn_counts() -> dict:
    """Elements per channel each BatchNorm of ResNet10 normalizes over in a
    batch of BATCH at IMG px."""
    from nbdt_torch.models import ResNet10

    counts, hooks = {}, []
    model = ResNet10(C)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: counts.__setitem__(name, inp[0].numel()
                                                               // inp[0].shape[1])))
    with torch.no_grad():
        model.eval()(torch.zeros(BATCH, 3, IMG, IMG))
    for h in hooks:
        h.remove()
    return counts


def test_vendored_tree_at_1000_classes_on_the_cpu(tmp_path):
    """The resnet18 config on the CPU at batch 2: 1000 classes take the
    vendored induced-efficientnet_b7b tree, one epoch of 2 steps."""
    from nbdt_torch.examples import train_imagenet

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_imagenet.main(["--config", CONFIGS["resnet18"], "--synthetic", "--device",
                                   "cpu", "--epochs", "1", "--batch-size", "2"])
    assert out["tree"].path_graph.endswith("Imagenet1000/graph-induced-efficientnet_b7b.json")
    assert len(out["tree"].classes) == 1000 and len(out["step_losses"]) == 2
    assert np.isfinite(out["step_losses"]).all()
    assert len(_lines(buf.getvalue())) == 1


# --- A13b: the classifier over tp -------------------------------------------


WORKER = r'''
import contextlib, io, json, os, sys
repo, rank, store, workdir, config = sys.argv[1:6]
rank = int(rank)
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from nbdt_torch.examples import train_imagenet
from nbdt_torch.models import get_model
from nbdt_torch.parallel import ColumnShardedLinear

state = torch.load(os.path.join(workdir, "init.pth"), weights_only=True)


def init_model(arch, num_classes, input_shape, seed=0, dtype=torch.float32, device="cuda"):
    model = get_model(arch, num_classes)
    model.load_state_dict(state)
    return model.to(device, memory_format=torch.channels_last).eval()


train_imagenet.init_model = init_model
out = {}
for tp in ("2", "1"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train_imagenet.main(["--config", config, "--synthetic", "--device", "cpu",
                                   "--tp", tp, "--multihost", "--coordinator-address", store,
                                   "--num-processes", "2", "--process-id", str(rank)])
    head = run["model"].linear
    out[tp] = {"text": buf.getvalue(), "mesh": run["mesh"], "losses": run["step_losses"],
               "epochs": run["epochs"], "sharded": isinstance(head, ColumnShardedLinear),
               "weight": list(head.weight.shape), "bias": list(head.bias.shape),
               "weight_rows": head.weight.detach()[:, :4].tolist()}
with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
'''


@pytest.fixture(scope="module")
def pair(tmp_path_factory, tiny_config):
    workdir = tmp_path_factory.mktemp("tp")
    torch.save(_init_state(), workdir / "init.pth")
    script = workdir / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT",
                                                            "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r),
                               f"file://{workdir / 'store'}", str(workdir), tiny_config],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    deadline = time.monotonic() + DEADLINE
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()  # a survivor blocks in its next collective
    outs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        pytest.fail("worker failed:\n" + "\n---\n".join(o[-3000:] for o in outs))
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("tp,mesh,rtol", [("2", [1, 2], 1e-4), ("1", [2, 1], 1e-5)])
def test_ranks_agree_and_match_one_process(pair, port_run, tp, mesh, rtol):
    """Both ranks' losses bit-identical, and close to the one-process port
    on the same global batches: at dp=2 within rtol 1e-5 (BatchNorm's
    statistics and the gradient mean sum over the ranks in another order);
    at tp=2 within rtol 1e-4, the spread JAX shows between its own tp=2 and
    tp=1 runs of this config (7e-5: the logits' column blocks and the
    features' gradient summed over tp); the epochs' top-1 and top-5
    equal."""
    r0, r1 = (r[tp] for r in pair)
    assert r0["mesh"] == r1["mesh"] == mesh
    assert f"mesh: dp={mesh[0]} tp={mesh[1]}" in r0["text"]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], port_run[1]["step_losses"], rtol=rtol)
    for got, want in zip(r0["epochs"], port_run[1]["epochs"]):
        assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


@pytest.mark.parametrize("tp", ["2", "1"])
def test_ranks_match_jax(pair, jax_run, tp):
    """Against JAX's example at --tp 1 (dp=8): the loss within 1e-4 of its 4
    decimals; at --tp 2 (dp=4 tp=2): no farther than JAX's tp=2 line is
    from its own tp=1 line, plus 1e-4; top-1 and top-5 equal to both."""
    assert "mesh: dp=4 tp=2" in jax_run["2"]
    tp1, tp2 = _lines(jax_run["1"]), _lines(jax_run["2"])
    for a, b, got in zip(tp1, tp2, pair[0][tp]["epochs"]):
        assert abs(got["loss"] - a[1]) <= 1e-4, (got["loss"], a)
        assert abs(got["loss"] - b[1]) <= abs(a[1] - b[1]) + 1e-4, (got["loss"], b, a)
        assert (got["top1"], got["top5"]) == a[2:] == b[2:]


def test_classifier_shards_are_column_blocks(pair):
    """At tp=2 each rank holds 4 of the 8 classes' weight rows (its block,
    in rank order, of the one [C, D] weight it started from) and the whole
    bias, as JAX shards the ``linear`` kernel and replicates its bias; at
    tp=1 the head stays whole."""
    init = _init_state()
    for rank, r in enumerate(pair):
        assert r["2"]["sharded"] and r["2"]["weight"] == [C // 2, 512]
        assert r["2"]["bias"] == [C]
        assert not r["1"]["sharded"] and r["1"]["weight"] == [C, 512]
    start = torch.cat([init["linear.weight"][r * C // 2:(r + 1) * C // 2, :4]
                       for r in range(2)])
    trained = torch.tensor(pair[0]["2"]["weight_rows"] + pair[1]["2"]["weight_rows"])
    assert trained.shape == start.shape and not torch.equal(trained, start)
    np.testing.assert_allclose(trained, start, atol=0.05)


def test_only_resnet_heads_are_sharded_as_in_jax():
    """JAX shards a leaf whose path ends in ("linear", "kernel"): the
    ResNets' heads. The port shards ResNet's ``linear`` (CIFAR) or ``fc``
    (torchvision) and leaves EfficientNet's, WRN's, the zoo's and ViT's
    heads whole; a class count that does not divide over tp raises, as
    JAX's placement does."""
    import jax

    from nbdt_tpu.models import get_model as jax_get_model
    from nbdt_tpu.parallel import make_mesh as jax_make_mesh
    from nbdt_tpu.parallel import shard_params as jax_shard_params

    from nbdt_torch.models import get_model
    from nbdt_torch.parallel import ColumnShardedLinear, shard_classifier

    def jax_sharded(arch):
        module = jax_get_model(arch, C)
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                    jax.numpy.zeros((1, 32, 32, 3))))
        params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
        placed = jax_shard_params(jax_make_mesh(tp=2), params, tp_shard_classifier=True)
        flat = jax.tree_util.tree_flatten_with_path(placed)[0]
        return ["/".join(k.key for k in path) for path, leaf in flat
                if "tp" in tuple(leaf.sharding.spec)]

    for arch, head in (("ResNet10", "linear"), ("resnet18", "fc"), ("efficientnet_b0", None),
                       ("mobilenet_v2", None), ("wrn28_10_cifar10", None)):
        want = jax_sharded(arch) if arch in ("ResNet10", "efficientnet_b0") else None
        with torch.device("meta"):
            model = get_model(arch, C)
        got = shard_classifier(model, None, 0, 2)
        assert got == ([head] if head else []), (arch, got)
        if want is not None:
            assert want == (["linear/kernel"] if head else []), (arch, want)
        if head:
            layer = getattr(model, head)
            assert isinstance(layer, ColumnShardedLinear) and layer.weight.shape[0] == C // 2
    with torch.device("meta"):
        with pytest.raises(ValueError, match="7 classes do not divide over tp=2"):
            shard_classifier(get_model("ResNet10", 7), None, 0, 2)
