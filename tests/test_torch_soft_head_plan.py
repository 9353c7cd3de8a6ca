"""The host plan of the port's fused head (``plan_soft_head``): which kernel
instance a shape takes, how the cluster instance splits classes and nodes
among its ranks, that the split is balanced, that shapes no instance fits
are refused, and that a plain walk of the plan, rank by rank, gives
``soft_head_reference``'s output. CPU only: the plan is host code."""

import functools

import numpy as np
import pytest
import torch

from test_torch_port import DAG, SYNTHETIC, _graph_tree, grouped_tree as _grouped
from test_torch_port import torch_threads  # noqa: F401  (autouse)


@functools.lru_cache(maxsize=None)
def _tree(name):
    from nbdt_torch.hierarchy.digraph import Digraph
    from nbdt_torch.tree import Tree

    if name == "synthetic-K3":
        return _graph_tree(Digraph, Tree, SYNTHETIC)
    if name == "dag":
        return _graph_tree(Digraph, Tree, DAG)
    if name == "grouped-K3-C300":
        return _grouped(300, 3)
    if name == "dag-C1500":
        return _grouped(1500, 2, dag=True)
    return Tree(name)


TREES = ["CIFAR100", "Imagenet1000", "synthetic-K3", "dag", "grouped-K3-C300", "dag-C1500"]


def _class_range(plan, rank, C):
    """Classes whose classifier column the kernel's rank ``rank`` computes."""
    return rank * plan.class_slice, min(C, (rank + 1) * plan.class_slice)


def _tree_rows(plan, rank, rows):
    """Rows of a ``rows``-row tile that rank ``rank`` takes through the tree
    phases: every q-th row from its own index."""
    return range(rank, rows, plan.q)


def _constants(tree, D, dtype=torch.float32, seed=0):
    from nbdt_torch.ops.soft_traversal import prepare_head_constants

    rng = np.random.RandomState(seed)
    C = tree.arrays.num_classes
    W = (rng.randn(D, C) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    return prepare_head_constants(tree.arrays, W, b, dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_vit_head_takes_the_cluster_instance(dtype):
    from nbdt_torch.ops.soft_traversal import SMEM_LIMIT, head_plan

    plan = head_plan(_constants(_tree("Imagenet1000"), 768, dtype), 256)
    assert plan.instance == "cluster"
    assert plan.q == 8 and plan.rows == 16 and plan.class_slice == 128
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.blocks >= 120


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_resnet_head_takes_the_streaming_instance(dtype):
    from nbdt_torch.ops.soft_traversal import head_plan

    plan = head_plan(_constants(_tree("CIFAR10"), 512, dtype), 8192)
    assert plan.instance == "stream"
    assert (plan.q, plan.rows) == (1, 2)  # 2 rows x 16 padded classes per warp step
    assert plan.blocks == 512


@pytest.mark.parametrize("C,instance", [(8, "stream"), (16, "stream"), (32, "stream"),
                                        (33, "cluster"), (128, "cluster"), (129, "cluster")])
def test_plan_switches_at_32_classes(C, instance):
    from nbdt_torch.ops.soft_traversal import head_plan

    plan = head_plan(_constants(_grouped(C, 2), 512), 259)
    assert plan.instance == instance
    assert plan.q == (1 if C <= 128 else 2)


def test_plan_unaligned_bf16_rows_take_the_cluster_instance():
    """The streaming instance reads 16-byte vectors of feats: D=100 holds a
    whole number of f32 vectors but not of bf16 ones."""
    from nbdt_torch.ops.soft_traversal import head_plan

    tree = _tree("CIFAR10")
    assert head_plan(_constants(tree, 100, torch.float32), 17).instance == "stream"
    assert head_plan(_constants(tree, 100, torch.bfloat16), 17).instance == "cluster"


@pytest.mark.parametrize("name", TREES)
def test_plan_owns_every_class_and_row_once(name):
    """Each class's classifier column belongs to exactly one rank, in a
    16-byte aligned slice; each row of a tile goes through the tree phases
    on exactly one rank."""
    from nbdt_torch.ops.soft_traversal import CLASS_SLICE, head_plan

    tree = _tree(name)
    C = tree.arrays.num_classes
    for D, dtype in ((768, torch.float32), (768, torch.bfloat16), (512, torch.float32)):
        plan = head_plan(_constants(tree, D, dtype), 259)
        q = plan.q
        assert 1 <= q <= 8
        classes = np.concatenate([np.arange(*_class_range(plan, r, C)) for r in range(q)])
        np.testing.assert_array_equal(classes, np.arange(C))
        assert all(_class_range(plan, r, C)[0] < _class_range(plan, r, C)[1] for r in range(q))
        if plan.instance == "cluster":
            assert plan.class_slice % CLASS_SLICE == 0
            assert all(_class_range(plan, r, C)[0] * 2 % 16 == 0 for r in range(q))  # bf16 too
        for rows in range(1, plan.rows + 1):
            taken = sorted(r for k in range(q) for r in _tree_rows(plan, k, rows))
            assert taken == list(range(rows))


@pytest.mark.parametrize("name", TREES)
def test_plan_balances_rank_workloads(name):
    """The tree work of a tile splits by rows, so on any tree two ranks'
    shares differ by one row's walk of the whole tree at most; the
    classifier splits by class slices, at most one 128-class pass apart."""
    from nbdt_torch.ops.soft_traversal import CLASS_SLICE, head_plan

    tree = _tree(name)
    hc = _constants(tree, 768)
    C = hc.num_classes
    for B, clusters in ((256, None), (256, 15), (259, 15), (17, None)):
        plan = head_plan(hc, B, clusters=clusters)
        rows = min(plan.rows, B)
        tree_rows = [len(_tree_rows(plan, k, rows)) for k in range(plan.q)]
        assert max(tree_rows) - min(tree_rows) <= 1
        assert max(tree_rows) == -(-rows // plan.q)
        widths = [b - a for a, b in (_class_range(plan, k, C) for k in range(plan.q))]
        assert max(widths) - min(widths) <= max(plan.class_slice - 1, 0)
        assert -(-max(widths) // CLASS_SLICE) - -(-min(widths) // CLASS_SLICE) <= 1


def test_plan_refuses_what_no_instance_fits():
    from nbdt_torch.ops.soft_traversal import plan_soft_head

    with pytest.raises(ValueError, match="no kernel instance fits"):
        plan_soft_head(8, 768, 20000, 19999, 2, torch.float32, 40000, 20000)
    with pytest.raises(ValueError, match="f32 or bf16"):
        plan_soft_head(8, 768, 10, 9, 2, torch.float16, 20, 10)
    # wider trees leave the lists in global memory: 3000 classes still fit,
    # 4000 do not; the feats chunks ride the W ring, so it keeps its four
    # stages at every width
    plan = plan_soft_head(8, 768, 1000, 999, 2, torch.float32, 2000, 1000)
    assert (plan.stages, plan.lists_in_smem) == (4, True)
    plan = plan_soft_head(8, 768, 2000, 1999, 2, torch.float32, 4000, 2000)
    assert (plan.stages, plan.lists_in_smem) == (4, True)
    assert not plan_soft_head(8, 768, 3000, 2999, 2, torch.float32, 6000, 3000).lists_in_smem
    with pytest.raises(ValueError, match="no kernel instance fits"):
        plan_soft_head(8, 768, 4000, 3999, 2, torch.float32, 8000, 4000)


def test_plan_sizes_tiles_to_one_wave_of_clusters():
    """Told how many clusters the card holds at once, the plan grows tiles
    (up to 20 rows) so that the batch fills one wave: 15 clusters take the
    ViT head's 256 rows as 15 tiles of 18 rows."""
    from nbdt_torch.ops.soft_traversal import head_plan

    hc = _constants(_tree("Imagenet1000"), 768)
    assert head_plan(hc, 256).rows == 16
    plan = head_plan(hc, 256, clusters=15)
    assert (plan.rows, plan.blocks) == (18, 120)
    assert head_plan(hc, 256, clusters=16).rows == 16
    assert head_plan(hc, 8192, clusters=15).rows == 20
    assert head_plan(hc, 256, block_b=8, clusters=15).rows == 8


@pytest.fixture
def one_thread():
    """One intra-op thread and full-f32 matmuls for the walk tests, and the
    worker's own settings back afterwards. On one thread the walk and the
    plain version do the same float operations in the same order on every
    row, so what they compare is the plan's partition, not how the CPU's
    thread pool happened to split a sum."""
    threads, precision = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_float32_matmul_precision(precision)


def _walk(feats, hc, plan):
    """The plan's work in plain PyTorch, rank by rank: each rank's
    classifier computes only its class slice; then, tile by tile, each rank
    takes only its rows of the tile through the whole tree."""
    from nbdt_torch.ops.soft_traversal import NEG
    from nbdt_torch.rules import exact_f32

    N, K, C = hc.num_nodes, hc.max_children, hc.num_classes
    S, B = N * K, feats.shape[0]
    slot_of = torch.repeat_interleave(torch.arange(S), hc.slot_ptr.diff().long())
    class_of = torch.repeat_interleave(torch.arange(C), hc.class_ptr.diff().long())
    valid = hc.slot_valid.bool()
    x = torch.empty(B, C)
    leaf = torch.empty(B, C)
    logp = torch.empty(B, S)
    for r in range(plan.q):  # the same product for every tile: all rows at once
        c0, c1 = _class_range(plan, r, C)
        with exact_f32():
            x[:, c0:c1] = feats.float() @ hc.W.float()[:, c0:c1] + hc.b[c0:c1]
    for row0 in range(0, B, plan.rows):
        tile = slice(row0, min(B, row0 + plan.rows))
        for r in range(plan.q):
            mine = [row0 + i for i in _tree_rows(plan, r, tile.stop - row0)]
            xr = x[mine]
            nl = torch.zeros(len(mine), S).index_add_(
                1, slot_of, xr[:, hc.slot_cls.long()] * hc.slot_w)
            nl3 = nl.reshape(len(mine), N, K)
            v = valid.reshape(N, K)
            m = torch.where(v, nl3, NEG).amax(-1, keepdim=True)
            m = torch.where(m > NEG / 2, m, 0.0)
            e = torch.where(v, torch.exp(nl3 - m), 0.0).sum(-1, keepdim=True)
            lse = torch.log(e.clamp_min(1e-30)) + m
            lp = torch.where(v, nl3 - lse, 0.0).reshape(len(mine), S)
            logp[mine] = lp
            leaf[mine] = torch.zeros(len(mine), C).index_add_(1, class_of, lp[:, hc.class_slot.long()])
    return leaf, x, torch.where(valid, logp, NEG)


@pytest.mark.parametrize("name", TREES)
def test_plan_walk_reproduces_the_plain_version(name, one_thread):
    from nbdt_torch.ops.soft_traversal import head_plan, soft_head_reference

    tree = _tree(name)
    hc = _constants(tree, 768)
    feats = torch.as_tensor(np.abs(np.random.RandomState(1).randn(37, 768)).astype(np.float32))
    plan = head_plan(hc, feats.shape[0], clusters=3)
    got = _walk(feats, hc, plan)
    want = soft_head_reference(feats, hc)
    # The same operations on fewer rows. A leaf is a sum of at most depth
    # log-probs, each within an ulp or so, so a mere reordering of the sums
    # would move it by about depth * ulp(max |leaf|): on CIFAR100 11 *
    # ulp(10.83) = 11 * 9.5e-7 = 1.05e-5, inside the 1e-6 + 1e-6 * 10.83 =
    # 1.18e-5 allowed there (Imagenet1000's 18 * ulp(16.02) = 3.4e-5 is
    # not). On one thread nothing is reordered: the two agree to the bit.
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# The widths of the heads the trees meet: ResNet18/34 and ViT-S (512), WRN-28-10
# (640), ViT-B (768), DenseNet/ResNet variants (1024), EfficientNet (1280-2560),
# ResNet50-152 (2048), AlexNet and VGG's classic head (4096).
WIDTHS = (512, 640, 768, 1024, 1280, 1536, 2048, 2560, 4096)
VENDORED = ("CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000")


def _reference_tile(ta, D, w_itemsize):
    """The batch tile the JAX kernel's host fit picks for this head (its
    node chunk, then the shrink loop from 512 rows), or None where it
    raises: nbdt_tpu/ops/soft_traversal.py's own functions and budget."""
    from nbdt_tpu.ops.soft_traversal import (
        VMEM_TOTAL_BUDGET, _pick_chunk, _round_up, _vmem_bytes)

    N, K, C = ta.membership.shape
    Cp, Np = _round_up(C, 128), _round_up(N, 128)
    cn = _pick_chunk(Np, K, Cp)
    tb = 512
    while tb > 8 and _vmem_bytes(tb, D, Cp, K, cn, True, w_itemsize) > VMEM_TOTAL_BUDGET:
        tb //= 2
    return tb if _vmem_bytes(tb, D, Cp, K, cn, True, w_itemsize) <= VMEM_TOTAL_BUDGET else None


@pytest.mark.parametrize("B", [8192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("name", VENDORED)
def test_plan_fits_wherever_the_reference_fits(name, D, dtype, B):
    """Every head the TPU kernel's fit accepts gets a plan here, within the
    card's shared memory; where the reference raises, the port may too."""
    from nbdt_torch.ops.soft_traversal import SMEM_LIMIT, head_plan

    hc = _constants(_tree(name), 8)  # the plan reads D from the call below
    tile = _reference_tile(_tree(name).arrays, D, 4 if dtype == torch.float32 else 2)
    if tile is None:
        return
    plan = head_plan(hc._replace(W=torch.empty(D, hc.num_classes, dtype=dtype)), B)
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("name", ["CIFAR100", "TinyImagenet200", "Imagenet1000"])
def test_cluster_shared_memory_does_not_grow_with_d(name):
    """The cluster block stages feats in the W ring's 64-column chunks, so
    its shared memory is the same at every head width."""
    from nbdt_torch.ops.soft_traversal import cluster_smem_bytes, head_plan

    hc = _constants(_tree(name), 8)
    for dtype in (torch.float32, torch.bfloat16):
        plans = [head_plan(hc._replace(W=torch.empty(D, hc.num_classes, dtype=dtype)), 256)
                 for D in WIDTHS]
        assert {p.instance for p in plans} == {"cluster"}
        assert len({p.smem_bytes for p in plans}) == 1
        p = plans[0]
        S = hc.num_nodes * hc.max_children
        sizes = {cluster_smem_bytes(D, hc.num_classes, S, hc.slot_cls.numel(),
                                    hc.class_slot.numel(), 4 if dtype == torch.float32 else 2,
                                    p.q, p.class_slice, p.stages, p.lists_in_smem)
                 for D in (64, 768, 2048, 4096)}
        assert sizes == {p.smem_bytes}


@pytest.mark.parametrize("name,D", [("CIFAR100", 2048), ("Imagenet1000", 2048),
                                    ("TinyImagenet200", 2560)])
def test_plan_walk_at_wide_heads(name, D, one_thread):
    """The plan at the heads C1 used to refuse (ResNet50's D=2048,
    EfficientNet-B7's 2560), walked rank by rank, gives the plain version."""
    from nbdt_torch.ops.soft_traversal import head_plan, soft_head_reference

    hc = _constants(_tree(name), D, seed=2)
    feats = torch.as_tensor(np.abs(np.random.RandomState(3).randn(23, D)).astype(np.float32))
    plan = head_plan(hc, feats.shape[0], clusters=2)
    assert plan.instance == "cluster"
    for g, w in zip(_walk(feats, hc, plan), soft_head_reference(feats, hc)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_imagenet1000_head_plans_at_the_zoo_widths():
    """The zoo's heads on the Imagenet1000 induced tree at a request of 256
    (DenseNet, GoogLeNet, ShuffleNetV2 1024; MobileNetV2, MNASNet 1280;
    Inception v3 2048; AlexNet and VGG's classic head 4096) plan the
    cluster instance in f32 and bf16, at one shared-memory size."""
    from nbdt_torch.ops.soft_traversal import SMEM_LIMIT, head_plan

    hc = _constants(_tree("Imagenet1000"), 8)
    for dtype in (torch.float32, torch.bfloat16):
        plans = [head_plan(hc._replace(W=torch.empty(D, 1000, dtype=dtype)), 256)
                 for D in (1024, 1280, 2048, 4096)]
        assert {p.instance for p in plans} == {"cluster"}
        assert len({p.smem_bytes for p in plans}) == 1 and plans[0].smem_bytes <= SMEM_LIMIT


@pytest.mark.gpu
def test_soft_head_kernel_at_d4096_matches_plain_on_gpu():
    """B1 against its plain version on the card at AlexNet's and VGG's head
    shape, B=256, D=4096, C=1000 (the Imagenet1000 induced tree): f32 W
    within 1e-4 on the leaf log-probs, bf16 W within 1e-2 relative on the
    leaf probabilities, argmax equal on rows whose plain top-2 gap exceeds
    1e-4, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbdt_torch.ops import soft_traversal as st

    ta = _tree("Imagenet1000").arrays
    rng = np.random.RandomState(0)
    W = (rng.randn(4096, ta.num_classes) / 64).astype(np.float32)
    feats = torch.as_tensor(np.abs(rng.randn(256, 4096)).astype(np.float32), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        hc = st.prepare_head_constants(ta, W, rng.randn(ta.num_classes), dtype=dtype)
        before = st.launches
        (got,) = st.fused_soft_head(feats.to(dtype), hc, want_aux=False)
        assert st.launches == before + 1
        (want,) = st.soft_head_reference(feats.to(dtype), hc, want_aux=False)
        torch.cuda.synchronize()
        assert st.last_launch["plan"].instance == "cluster"
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        else:
            torch.testing.assert_close(got.exp(), want.exp(), rtol=1e-2, atol=1e-4)
        top2 = want.topk(2, dim=1).values
        decided = top2[:, 0] - top2[:, 1] > 1e-4
        assert torch.equal(got.argmax(1)[decided], want.argmax(1)[decided])
