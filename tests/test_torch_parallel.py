"""nbdt_torch.parallel and the trainer on a mesh, against the one-process
port and against JAX's ``Trainer(mesh=...)``.

ResNet10, 7 classes, 16px, ``SyntheticDataset(size=32)`` and a global batch
of 16, as tests/test_multihost.py runs the JAX mesh. Two worker processes
form one gloo group through a ``file://`` store under ``tmp_path`` (no port
to race for) and run, in one pair: the host-fed and the cached trainer, the
cached one under remat, a resume into ``zero=True``, the ``.dcp`` round
trip, the evals, ``shard_serving``, ``shard_batch`` and the cross-rank
BatchNorm against a plain one on the concatenated batch. Each writes its
results as JSON; the tests here read them and hold them to the references:
the one-process port ``Trainer`` on the concatenated global batches, and
JAX's ``Trainer(mesh=make_mesh(n_devices=2))`` (the conftest gives JAX 8
virtual CPU devices) on the same flax weights.

Host-fed parity uses ``transform_val`` batches: each shard's loader draws
its own host augment, in both packages. Cached parity keeps the augment,
which the trainer draws for the whole global batch on every rank.
"""

import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_train import _assert_state_matches, _bn_counts, _init, _port_model, _trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, IMG, SIZE, GLOBAL = 7, 16, 32, 16
LR = 0.05
DEADLINE = 300  # seconds for the pair; a rank that dies kills its sibling

WORKER = r'''
import json, os, sys
repo, rank, store, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tests"))
import numpy as np
import torch
torch.set_num_threads(1)

from nbdt_torch.parallel import (CrossRankBatchNorm2d, initialize_multihost, make_mesh,
                                 shard_batch, state_bytes, zero_sharding)
from nbdt_torch.data import DataLoader, SyntheticDataset
from nbdt_torch.models import ResNet10
from nbdt_torch.losses import cross_entropy
from nbdt_torch.parallel import convert_batchnorm
from nbdt_torch.serving import make_serving_fn, shard_serving
from nbdt_torch.trainer import TrainConfig, Trainer
from nbdt_torch.analysis import SoftEmbeddedDecisionRules
from nbdt_torch.hierarchy.digraph import Digraph
from nbdt_torch.tree import Tree
from test_torch_port import SYNTHETIC, _graph_tree

C, IMG, SIZE, GLOBAL, LR = 7, 16, 32, 16, 0.05
out = {}
out["world"] = initialize_multihost(store, 2, rank)
out["world_again"] = initialize_multihost(store, 2, rank)  # idempotent
mesh = make_mesh(device="cpu")
out["mesh"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
tree = _graph_tree(Digraph, Tree, SYNTHETIC)
init = torch.load(os.path.join(workdir, "init.pth"), weights_only=True)


def model():
    m = ResNet10(C)
    m.load_state_dict(init)
    return m


def cpu_state(tr):
    return {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}


ds = SyntheticDataset(num_classes=C, size=SIZE, image_size=IMG)
local = GLOBAL // 2


def train_loader():
    """This rank's shard, shuffled as from a fresh start (a loader's draws
    move on with every epoch it serves)."""
    return DataLoader(ds, local, shuffle=True, transform=ds.transform_val(), num_shards=2,
                      shard_id=rank)


vl = DataLoader(ds, local, transform=ds.transform_val(), drop_last=False, pad_last=True,
                num_shards=2, shard_id=rank)
ckpt = os.path.join(workdir, "ckpt")
kw = dict(dataset="CIFAR10", arch="ResNet10", batch_size=GLOBAL, epochs=2,
          loss="SoftTreeSupLoss", lr=LR, checkpoint_dir=ckpt)

# host-fed: this rank's 8 rows of each global batch of 16
host = Trainer(TrainConfig(**kw), model(), train_loader(), vl, tree=tree, device="cpu",
               mesh=mesh)
out["host"] = host.train_epoch(0)["step_losses"]
out["host_acc"] = host.evaluate(0, checkpoint=False)
torch.save(cpu_state(host), os.path.join(workdir, f"host{rank}.pth"))


class HostRules(SoftEmbeddedDecisionRules):
    """Scores on the host (no device_eval): the eval's slow path."""

    def _update_batch(self, outputs, targets):
        return super()._update_batch(outputs, targets)


host.analyzer = HostRules(tree=tree, device="cpu")
host.analyzer.start_epoch(0)
out["host_acc_slow"] = host.evaluate(0, checkpoint=False)
out["host_analyzer"] = [host.analyzer.metric.correct, host.analyzer.metric.total]
host.analyzer = None

# cached: every rank draws the global permutation and augment, keeps its rows
cached_loader = DataLoader(ds, GLOBAL, shuffle=True, transform=ds.transform_train())
for name, extra in (("cached", {}), ("remat", {"remat": True})):
    tr = Trainer(TrainConfig(cache_dataset=True, **extra, **kw), model(), cached_loader, vl,
                 tree=tree, device="cpu", mesh=mesh)
    out[name] = tr.train_epoch(0)["step_losses"]
    out[name + "_acc"] = tr.evaluate(0, checkpoint=False)
    torch.save(cpu_state(tr), os.path.join(workdir, f"{name}{rank}.pth"))

# save (rank 0 writes, shared directory), resume into ZeRO-1 and into plain DDP
path = host.save(1, out["host_acc"])
out["resumed"] = {}
for zero in (False, True):
    tr = Trainer(TrainConfig(**kw), ResNet10(C), train_loader(), vl, tree=tree, device="cpu",
                 mesh=mesh, zero=zero)
    tr.load(path)
    out["resumed_equal"] = all(torch.equal(v, cpu_state(host)[k])
                               for k, v in cpu_state(tr).items())
    seen = []
    tr.optimizer.register_step_post_hook(
        lambda opt, a, k: seen.append(opt.optim.param_groups[0]["lr"] if zero
                                      else opt.param_groups[0]["lr"]))
    out["resumed"][str(zero)] = tr.train_epoch(1)["step_losses"]
    if zero:
        out["zero_lrs"] = seen
        out["zero_schedule"] = [tr.lr_at(2 + i) for i in range(len(seen))]
        out["zero_share"] = zero_sharding(tr.optimizer)
        out["zero_bytes"] = state_bytes(tr.optimizer)
        out["param_bytes"] = sum(p.numel() * p.element_size() for p in tr.model.parameters())
        out["n_params"] = len(list(tr.model.parameters()))

# the directory checkpoint: collective, read back bitwise
host.config.checkpoint_backend = "orbax"
dcp_path = host.save(2, out["host_acc"])
back = Trainer(TrainConfig(checkpoint_backend="orbax", **kw), ResNet10(C), train_loader(), vl,
               tree=tree, device="cpu", mesh=mesh)
back.load(dcp_path)
out["dcp"] = [dcp_path, back.start_epoch,
              all(torch.equal(v, cpu_state(host)[k]) for k, v in cpu_state(back).items())]

# serving: each rank serves its rows, every rank returns the whole batch
x = np.random.RandomState(3).randint(0, 256, (GLOBAL, IMG, IMG, 3), dtype=np.uint8)
fn = make_serving_fn(host.model, tree, bf16=False, uint8_input=True, device="cpu")
full, sharded = fn(x), shard_serving(fn, mesh)(torch.as_tensor(x))
out["serving_max_diff"] = float((full - sharded).abs().max())
out["serving_shape"] = list(sharded.shape)
try:
    shard_serving(fn, mesh)(torch.as_tensor(x[:GLOBAL - 1]))
except ValueError as e:
    out["serving_error"] = str(e)

out["shard_batch"] = shard_batch(mesh, np.arange(GLOBAL * 3).reshape(GLOBAL, 3)).tolist()

# the cross-rank BatchNorm against a plain one on the concatenated batch
g = torch.Generator().manual_seed(0)
xg = torch.randn(8, 6, 5, 5, generator=g) * 3 + 1
dy = torch.randn(8, 6, 5, 5, generator=g)
w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
rows = slice(4 * rank, 4 * rank + 4)
out["bn"] = {}
for dtype in ("float32", "bfloat16"):
    dt = getattr(torch, dtype)
    plain, cross = torch.nn.BatchNorm2d(6), CrossRankBatchNorm2d(6)
    for m in (plain, cross):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    errs = {}
    for step in range(2):
        xp = xg.to(dt).clone().requires_grad_()
        xc = xg[rows].to(dt).clone().requires_grad_()
        yp, yc = plain(xp), cross(xc)
        (yp.float() * dy).sum().backward()
        (yc.float() * dy[rows]).sum().backward()
        errs[f"y{step}"] = float((yc - yp[rows]).detach().float().abs().max())
        errs[f"dx{step}"] = float((xc.grad.float() - xp.grad[rows].float()).abs().max())
        errs["dtype"] = str(yc.dtype)
    gw = torch.stack([cross.weight.grad, cross.bias.grad])
    torch.distributed.all_reduce(gw)  # the sum over ranks, as DDP's mean times the world
    errs["dw"] = float((gw[0] - plain.weight.grad).abs().max())
    errs["db"] = float((gw[1] - plain.bias.grad).abs().max())
    errs["running_mean"] = float((cross.running_mean - plain.running_mean).abs().max())
    errs["running_var"] = float((cross.running_var - plain.running_var).abs().max())
    errs["tracked"] = [int(cross.num_batches_tracked), int(plain.num_batches_tracked)]
    out["bn"][dtype] = errs

# one DDP step's gradients (ResNet10, 32px, 16 rows a rank) for the f64 check
torch.manual_seed(20)
net = convert_batchnorm(ResNet10(10))
gx = torch.Generator().manual_seed(1)
x32 = torch.randn(32, 3, 32, 32, generator=gx)
y32 = torch.randint(0, 10, (32,), generator=gx)
ddp = torch.nn.parallel.DistributedDataParallel(net, broadcast_buffers=False)
cross_entropy(ddp(x32[16 * rank:16 * rank + 16]).float(), y32[16 * rank:16 * rank + 16]).backward()
torch.save({n: p.grad for n, p in net.named_parameters()}, os.path.join(workdir, f"grad{rank}.pth"))

with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
'''


def _launch(workdir):
    """Runs both ranks; returns their results, or fails with both outputs.
    Each worker has one thread: two of them share the test's cores."""
    script = workdir / "worker.py"
    script.write_text(WORKER)
    store = f"file://{workdir / 'store'}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT",
                                                            "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r), store, str(workdir)],
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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("pair")
    torch.save(_port_model(_init_variables()).state_dict(), workdir / "init.pth")
    return workdir, _launch(workdir)


@functools.lru_cache(maxsize=None)
def _init_variables():
    """One ResNet10 init at 16px, 7 classes (test_torch_train's)."""
    return _init()[1]


class _Concat:
    """The global batches of a two-shard run, each the concatenation of
    both shards' batches in rank order: what the ranks train on together."""

    def __init__(self, pkg: str, **kw):
        import importlib

        data = importlib.import_module(f"{pkg}.data")
        ds = data.SyntheticDataset(num_classes=C, size=SIZE, image_size=IMG)
        self.dataset = ds
        self.shards = [data.DataLoader(ds, GLOBAL // 2, transform=ds.transform_val(),
                                       num_shards=2, shard_id=r, **kw) for r in range(2)]

    def __len__(self):
        return len(self.shards[0])

    def __iter__(self):
        for parts in zip(*self.shards):
            yield tuple(np.concatenate(p) for p in zip(*parts))


def _config(pkg: str, tmp_path, **extra):
    import importlib

    cfg = importlib.import_module(f"{pkg}.trainer").TrainConfig
    return cfg(dataset="CIFAR10", arch="ResNet10", batch_size=GLOBAL, epochs=2,
               loss="SoftTreeSupLoss", lr=LR, checkpoint_dir=str(tmp_path), **extra)


def _one_process(tmp_path, cached: bool):
    """The port's one-process trainer on the same global batches."""
    from nbdt_torch.data import DataLoader, SyntheticDataset
    from nbdt_torch.trainer import Trainer

    _, ttree = _trees()
    ds = SyntheticDataset(num_classes=C, size=SIZE, image_size=IMG)
    test = DataLoader(ds, GLOBAL, transform=ds.transform_val(), drop_last=False, pad_last=True)
    if cached:
        train = DataLoader(ds, GLOBAL, shuffle=True, transform=ds.transform_train())
        cfg = _config("nbdt_torch", tmp_path, cache_dataset=True)
    else:
        train, cfg = _Concat("nbdt_torch", shuffle=True), _config("nbdt_torch", tmp_path)
    tr = Trainer(cfg, _port_model(_init_variables()), train, test, tree=ttree, device="cpu")
    losses = tr.train_epoch(0)["step_losses"]
    return tr, losses, tr.evaluate(0, checkpoint=False)


def _global_counts():
    return {k: 2 * v for k, v in _bn_counts(_port_model(_init_variables())).items()}


@pytest.mark.parametrize("mode", ["host", "cached", "remat"])
def test_both_ranks_report_bit_identical_losses(pair, mode):
    _, (r0, r1) = pair
    assert len(r0[mode]) == SIZE // GLOBAL
    assert r0[mode] == r1[mode] and np.isfinite(r0[mode]).all()
    assert r0[mode + "_acc"] == r1[mode + "_acc"]


@pytest.mark.parametrize("mode", ["host", "cached"])
def test_two_ranks_match_the_one_process_trainer(pair, mode, tmp_path):
    """The union of the ranks' rows is the one-process batch, and the
    cross-rank BatchNorm normalises over it: the losses agree within 1e-5,
    the eval alike, and the weights and running statistics within 1e-4
    after the two steps. Tighter does not hold for any two f32 runs: their
    gradients part from the f64 one by a few tenths of a percent of the
    largest element (test_two_ranks_gradient_is_as_exact_as_one_process),
    and the second step carries that into the weights."""
    workdir, (r0, _) = pair
    tr, losses, acc = _one_process(tmp_path, cached=mode == "cached")
    np.testing.assert_allclose(r0[mode], losses, rtol=1e-5)
    assert r0[mode + "_acc"] == acc
    for r in range(2):
        state = torch.load(workdir / f"{mode}{r}.pth", weights_only=True)
        for k, v in tr.model.state_dict().items():
            torch.testing.assert_close(state[k], v, rtol=2e-4, atol=1e-4,
                                       msg=lambda m, k=k: f"{k}: {m}")


def test_two_ranks_match_the_jax_mesh_trainer(pair, tmp_path):
    """JAX's ``Trainer(mesh=make_mesh(n_devices=2))`` on the same flax
    weights and the same global batches: the last step's loss within
    test_torch_train's tolerance, the state as there (JAX's biased variance
    updates mapped through n/(n-1), n the global count)."""
    from nbdt_tpu.parallel import make_mesh
    from nbdt_tpu.trainer import Trainer as JTrainer

    workdir, (r0, _) = pair
    module, variables = _init()
    jtree, _ = _trees()
    train = _Concat("nbdt_tpu", shuffle=True)
    jtr = JTrainer(_config("nbdt_tpu", tmp_path), module, variables, train, train, tree=jtree,
                   mesh=make_mesh(n_devices=2))
    j = jtr.train_epoch(0)
    np.testing.assert_allclose(r0["host"][-1], j["loss"], rtol=2e-5, atol=1e-6)
    state = torch.load(workdir / "host0.pth", weights_only=True)
    _assert_state_matches(state, jtr.variables, variables, _global_counts(), SIZE // GLOBAL)


def test_eval_counts_are_summed_over_the_ranks(pair, tmp_path):
    """Each rank scores its shard of the test set; the counts (the metric's
    and a host-scoring analyzer's) are all-reduced, so both ranks report the
    one-process accuracy of the same weights."""
    from nbdt_torch.analysis import SoftEmbeddedDecisionRules

    workdir, (r0, r1) = pair
    tr, _, _ = _one_process(tmp_path, cached=False)
    tr.model.load_state_dict(torch.load(workdir / "host0.pth", weights_only=True))
    _, ttree = _trees()
    tr.analyzer = SoftEmbeddedDecisionRules(tree=ttree, device="cpu")
    tr.analyzer.start_epoch(0)
    acc = tr.evaluate(0, checkpoint=False)
    for r in (r0, r1):
        assert r["host_acc"] == r["host_acc_slow"] == acc
        assert r["host_analyzer"] == [tr.analyzer.metric.correct, tr.analyzer.metric.total]
    assert tr.analyzer.metric.total == SIZE


def test_remat_recomputes_the_same_cross_rank_statistics(pair):
    """Under remat the backward re-runs the forward, its collectives
    included: the same losses and the same state as without it, and the
    running statistics updated once a step."""
    workdir, (r0, _) = pair
    np.testing.assert_allclose(r0["remat"], r0["cached"], rtol=1e-6)
    for r in range(2):
        a = torch.load(workdir / f"remat{r}.pth", weights_only=True)
        b = torch.load(workdir / f"cached{r}.pth", weights_only=True)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6, msg=k)


def test_zero_after_a_resume(pair):
    """ZeRO-1 resumed from a checkpoint: both ranks report the same losses,
    the plain DDP trainer's within 1e-6; each rank's momentum covers a
    disjoint share of the parameters, the shares cover them all, and each
    share is under the whole; the schedule's learning rate reaches each
    rank's local optimizer."""
    _, (r0, r1) = pair
    assert r0["resumed_equal"] and r1["resumed_equal"]
    assert r0["resumed"]["True"] == r1["resumed"]["True"]
    np.testing.assert_allclose(r0["resumed"]["True"], r0["resumed"]["False"], rtol=1e-6)
    shares = [set(r0["zero_share"]), set(r1["zero_share"])]
    assert not shares[0] & shares[1] and shares[0] | shares[1] == set(range(r0["n_params"]))
    for r in (r0, r1):
        assert 0 < r["zero_bytes"] < r["param_bytes"]
        assert r["zero_lrs"] == r["zero_schedule"] and len(r["zero_lrs"]) == 2
    assert r0["zero_bytes"] + r1["zero_bytes"] == r0["param_bytes"]


def test_directory_checkpoint_round_trip(pair):
    """``checkpoint_backend="orbax"`` writes a ``.dcp`` directory with every
    rank; a fresh mesh trainer reads it back bitwise, and its meta."""
    _, (r0, r1) = pair
    for r in (r0, r1):
        path, epoch, equal = r["dcp"]
        assert path.endswith(".dcp") and os.path.isdir(path) and equal and epoch == 2
        assert os.path.exists(os.path.join(path, ".metadata"))
        assert os.path.exists(path[: -len(".dcp")] + ".json")


def test_shard_serving_returns_the_whole_batch(pair):
    """Each rank serves its rows and gathers: every rank returns what the fn
    returns on the whole batch; a batch that does not divide raises, as
    JAX's sharded jit does."""
    _, (r0, r1) = pair
    for r in (r0, r1):
        assert r["serving_shape"] == [GLOBAL, C]
        assert r["serving_max_diff"] <= 1e-6
        assert "should be divisible by 2" in r["serving_error"]


def test_shard_serving_refuses_what_jax_refuses():
    """JAX's own error on an indivisible batch, for the message's wording."""
    import jax.numpy as jnp

    from nbdt_tpu.parallel import make_mesh
    from nbdt_tpu.serving import shard_serving

    with pytest.raises(ValueError, match="should be divisible by 2"):
        shard_serving(lambda x: x * 2, make_mesh(n_devices=2))(jnp.ones((GLOBAL - 1, 3)))


def test_shard_batch_rows_match_jax(pair):
    from nbdt_tpu.parallel import make_mesh, shard_batch

    _, ranks = pair
    arr = np.arange(GLOBAL * 3).reshape(GLOBAL, 3)
    placed = shard_batch(make_mesh(n_devices=2), arr)
    shards = sorted(placed.addressable_shards, key=lambda s: s.index[0].start or 0)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(np.asarray(res["shard_batch"]), np.asarray(shards[r].data))


def test_two_rank_group_and_mesh(pair):
    _, ranks = pair
    for r in ranks:
        assert r["world"] == r["world_again"] == 2
        assert r["mesh"] == [[2, 1], ["dp", "tp"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_rank_batchnorm_is_the_global_batchnorm(pair, dtype):
    """Two training steps of the cross-rank BatchNorm on each rank's 4 rows
    against ``nn.BatchNorm2d`` on all 8: outputs, input and affine
    gradients, running statistics and step count. bf16 inputs (the
    backbones' ``bn_impl="bf16"``) compute in f32 and round once, as torch's
    BatchNorm does: within bf16's rounding of the output."""
    _, ranks = pair
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    for r in ranks:
        e = r["bn"][dtype]
        assert e["dtype"] == f"torch.{dtype}"
        for key in ("y0", "y1", "dx0", "dx1"):
            assert e[key] <= tol, (key, e[key])
        for key in ("dw", "db", "running_mean", "running_var"):
            assert e[key] <= 1e-4, (key, e[key])
        assert e["tracked"] == [2, 2]


@pytest.fixture
def one_rank_group():
    """Tears down the one-rank group ``make_mesh`` forms, so the process
    holds none after the test."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("n,dp,tp", [(8, None, 1), (8, None, 2), (8, 4, 2), (8, 2, 4),
                                     (8, None, 3), (8, 3, 2), (4, 2, 1), (1, None, 1)])
def test_mesh_shape_matches_jax(n, dp, tp):
    """``(dp, tp)`` from the device count, with JAX's assertions."""
    from nbdt_tpu.parallel import make_mesh as jmake_mesh

    from nbdt_torch.parallel import mesh_shape

    try:
        want = jmake_mesh(n_devices=n, dp=dp, tp=tp).devices.shape
    except AssertionError as e:
        with pytest.raises(AssertionError, match=re.escape(str(e))):
            mesh_shape(n, dp, tp)
        return
    assert mesh_shape(n, dp, tp) == want


def test_make_mesh_forms_a_one_rank_group(one_rank_group):
    """With no group up, ``make_mesh`` forms a one-rank gloo group on the
    CPU (``--mesh`` on one device); a mesh over more devices than ranks is
    refused; ``initialize_multihost`` is then a no-op."""
    import torch.distributed as dist

    from nbdt_torch.parallel import initialize_multihost, is_multiprocess, make_mesh

    mesh = make_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
    assert dist.get_backend() == "gloo" and not is_multiprocess()
    assert initialize_multihost() == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(n_devices=2, device="cpu")


def test_initialize_multihost_needs_a_group_to_join(monkeypatch):
    from nbdt_torch.parallel import distributed

    for var in ("NBDT_COORDINATOR", "NBDT_NUM_PROCESSES", "NBDT_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator_address, num_processes, process_id"):
        distributed.initialize_multihost()
    assert distributed._init_method("localhost:1234") == "tcp://localhost:1234"
    assert distributed._init_method("file:///tmp/store") == "file:///tmp/store"


def test_shard_params_refuses_the_tensor_sharded_classifier(one_rank_group):
    from nbdt_torch.models import ResNet10
    from nbdt_torch.parallel import make_mesh, shard_params

    mesh = make_mesh(device="cpu")
    model = ResNet10(C)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_params(mesh, model) is model  # one rank: rank 0's own weights
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    with pytest.raises(NotImplementedError, match="A13b"):
        shard_params(mesh, model, tp_shard_classifier=True)


def test_convert_batchnorm_keeps_the_state_dict():
    """The swap keeps names, keys and the very tensors; at one rank (no
    group) the cross-rank BatchNorm is ``nn.BatchNorm2d``."""
    from nbdt_torch.models import ResNet10
    from nbdt_torch.parallel import CrossRankBatchNorm2d, convert_batchnorm

    plain = ResNet10(C)
    model = ResNet10(C)
    model.load_state_dict(plain.state_dict())
    tensors = {k: v.data_ptr() for k, v in model.state_dict().items()}
    convert_batchnorm(model)
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == tensors
    assert sum(isinstance(m, CrossRankBatchNorm2d) for m in model.modules()) == 12
    x = torch.randn(4, 3, IMG, IMG)
    torch.testing.assert_close(model.train()(x), plain.train()(x), rtol=0, atol=0)
    torch.testing.assert_close(model.state_dict(), plain.state_dict(), rtol=0, atol=0)
    with pytest.raises(TypeError, match="BatchNorm1d"):
        convert_batchnorm(torch.nn.Sequential(torch.nn.BatchNorm1d(3)))


def test_zero_requires_a_mesh(capsys):
    """``zero=True`` without a mesh raises; the CLI's ``--zero`` without
    ``--mesh`` exits with the JAX CLI's message."""
    from nbdt_tpu.main import main as jmain

    from nbdt_torch.data import DataLoader, SyntheticDataset
    from nbdt_torch.main import main
    from nbdt_torch.models import ResNet10
    from nbdt_torch.trainer import TrainConfig, Trainer

    ds = SyntheticDataset(num_classes=C, size=8, image_size=IMG)
    loader = DataLoader(ds, 4, transform=ds.transform_val())
    with pytest.raises(ValueError, match="zero=True requires a mesh"):
        Trainer(TrainConfig(loss="CrossEntropyLoss"), ResNet10(C), loader, loader,
                device="cpu", zero=True)
    argv = ["--synthetic", "--arch", "ResNet10", "--batch-size", "4", "--zero"]
    with pytest.raises(SystemExit) as want:
        jmain(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == "error: --zero requires --mesh"


def test_cli_mesh_zero_profile_and_directory_checkpoints(tmp_path, capsys, one_rank_group):
    """``--mesh --zero --profile DIR --checkpoint-backend orbax`` at one
    rank: it trains, writes the ``.dcp`` directories and a trace, and
    ``--resume`` takes the ``.dcp`` back."""
    from nbdt_torch.main import main

    argv = ["--synthetic", "--dataset", "CIFAR10", "--arch", "ResNet10", "--loss",
            "SoftTreeSupLoss", "--epochs", "1", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--no-progress", "--mesh", "--zero",
            "--checkpoint-backend", "orbax"]
    acc = main(argv + ["--profile", str(tmp_path / "trace")])
    assert 0 <= acc <= 100
    out = capsys.readouterr().out
    assert "==> dp mesh over 1 devices" in out
    fname = "ckpt-CIFAR10-ResNet10-induced-ResNet10-SoftTreeSupLoss"
    assert (tmp_path / f"{fname}-last.dcp" / ".metadata").exists()
    assert (tmp_path / f"{fname}-last.json").exists()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    graph = tmp_path / "CIFAR10" / "graph-induced-ResNet10.json"
    main(argv + ["--resume", "--eval", "--path-graph", str(graph)])
    assert f"Resumed from {tmp_path / fname}-last.dcp" in capsys.readouterr().out


@pytest.mark.gpu
def test_one_nccl_rank_on_the_card():
    """One NCCL rank (``make_mesh()`` on the card): the mesh trainer's DDP
    steps with the cross-rank BatchNorm equal the plain trainer's within
    1e-4; the cross-rank BatchNorm's CUDA path (NCCL) holds against its CPU
    path (a gloo group) and against ``F.batch_norm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    import torch.nn.functional as F

    from nbdt_torch.data import DataLoader, SyntheticDataset
    from nbdt_torch.hierarchy.digraph import Digraph
    from nbdt_torch.models import ResNet10
    from nbdt_torch.parallel import make_mesh
    from nbdt_torch.parallel.syncbn import _CrossRankNorm
    from nbdt_torch.trainer import TrainConfig, Trainer
    from nbdt_torch.tree import Tree
    from test_torch_port import SYNTHETIC, _graph_tree

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl"
        tree = _graph_tree(Digraph, Tree, SYNTHETIC)
        ds = SyntheticDataset(num_classes=C, size=SIZE, image_size=IMG)
        torch.manual_seed(0)
        init = ResNet10(C)
        losses = []
        for kw in ({}, {"mesh": mesh}):
            cfg = TrainConfig(dataset="CIFAR10", arch="ResNet10", batch_size=GLOBAL, epochs=2,
                              loss="SoftTreeSupLoss", lr=LR, cache_dataset=True,
                              checkpoint_dir="unused")
            loader = DataLoader(ds, GLOBAL, shuffle=True, transform=ds.transform_train())
            tr = Trainer(cfg, init, loader, loader, tree=tree, **kw)
            losses.append(tr.train_epoch(0)["step_losses"] + tr.train_epoch(1)["step_losses"])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)

        gloo = dist.new_group(backend="gloo")
        g = torch.Generator().manual_seed(0)
        x = torch.randn(8, 6, 5, 5, generator=g) * 3 + 1
        dy = torch.randn(8, 6, 5, 5, generator=g)
        w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
        got = {}
        for dev, group in (("cuda", None), ("cpu", gloo)):
            xd = x.to(dev).requires_grad_()
            wd, bd = w.to(dev).requires_grad_(), b.to(dev).requires_grad_()
            y, mean, var = _CrossRankNorm.apply(xd, wd, bd, 1e-5, group, 1)
            (y * dy.to(dev)).sum().backward()
            got[dev] = [t.detach().cpu() for t in (y, mean, var, xd.grad, wd.grad, bd.grad)]
        for a, c in zip(got["cuda"], got["cpu"]):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
        xr = x.clone().requires_grad_()
        want = F.batch_norm(xr, None, None, w, b, training=True, eps=1e-5)
        torch.testing.assert_close(got["cuda"][0], want.detach(), rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_two_ranks_gradient_is_as_exact_as_one_process(pair, monkeypatch):
    """One step's gradient of a ResNet10 at 32px (32 images, 16 a rank)
    against its float64 value: the pair's error is no larger than the
    one-process f32 gradient's. Neither is small: f32 sums on such a
    network part from f64 by a few tenths of a percent of the largest
    element, which is why the trajectories of two f32 runs part step by
    step while their first losses agree to the last bit."""
    from nbdt_torch.losses import cross_entropy
    from nbdt_torch.models import ResNet10

    workdir, _ = pair
    torch.manual_seed(20)
    net = ResNet10(10)
    gx = torch.Generator().manual_seed(1)
    x = torch.randn(32, 3, 32, 32, generator=gx)
    y = torch.randint(0, 10, (32,), generator=gx)
    net64 = __import__("copy").deepcopy(net).double()
    cross_entropy(net.train()(x).float(), y).backward()
    with monkeypatch.context() as m:  # the backbone's f32 casts become f64 ones
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        cross_entropy(net64.train()(x.double()), y).backward()
    want = dict(net64.named_parameters())

    def err(grads):
        return max(float((g.double() - want[k].grad).abs().max() / want[k].grad.abs().max())
                   for k, g in grads.items())

    single = err({k: p.grad for k, p in net.named_parameters()})
    pair_errs = [err(torch.load(workdir / f"grad{r}.pth", weights_only=True)) for r in range(2)]
    print(f"f32 gradient against f64 (largest difference over the largest element): one "
          f"process {single:.3g}, ranks {pair_errs[0]:.3g} and {pair_errs[1]:.3g}")
    assert max(pair_errs) <= 2 * single + 1e-6, (pair_errs, single)
