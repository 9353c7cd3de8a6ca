"""The host plan of the port's fused head (``plan_soft_head``): which kernel
instance a shape takes, how the cluster instance splits classes and nodes
among its ranks, that the split is balanced, that shapes no instance fits
are refused, and that a plain walk of the plan, rank by rank, gives
``soft_head_reference``'s output. CPU only: the plan is host code."""

import numpy as np
import pytest
import torch

from test_torch_port import DAG, SYNTHETIC, _graph_tree, grouped_tree as _grouped


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
    # wider trees keep fewer W chunks in flight, then leave the lists in
    # global memory: 3000 classes still fit, 4000 do not
    plan = plan_soft_head(8, 768, 1000, 999, 2, torch.float32, 2000, 1000)
    assert (plan.stages, plan.lists_in_smem) == (4, True)
    plan = plan_soft_head(8, 768, 2000, 1999, 2, torch.float32, 4000, 2000)
    assert (plan.stages, plan.lists_in_smem) == (3, True)
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
def test_plan_walk_reproduces_the_plain_version(name):
    from nbdt_torch.ops.soft_traversal import head_plan, soft_head_reference

    tree = _tree(name)
    hc = _constants(tree, 768)
    feats = torch.as_tensor(np.abs(np.random.RandomState(1).randn(37, 768)).astype(np.float32))
    plan = head_plan(hc, feats.shape[0], clusters=3)
    got = _walk(feats, hc, plan)
    want = soft_head_reference(feats, hc)
    # The same operations on fewer rows: equal but for the order in which the
    # CPU's threaded matmul and index_add_ split their sums (an ulp or two).
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_phase_profiler_finds_every_phase_in_the_kernel_source():
    """``python -m nbdt_torch.tools.soft_head_phases`` stamps the kernel at
    fixed places in its source; each must be there exactly once."""
    from nbdt_torch.tools import soft_head_phases as phases

    src = phases.instrumented_source()
    assert src.count("g_stamp[blockIdx.x") == len(phases.ANCHORS)
    for instance, names in phases.PHASES.items():
        stamps = [k for inst, k, _, _ in phases.ANCHORS if inst == instance]
        assert stamps == list(range(len(names) + 1))
