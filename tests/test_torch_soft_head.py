"""nbdt_torch.ops.soft_traversal against nbdt_tpu's Pallas head run in
interpret mode, as tests/test_ops.py runs it. On the CPU the port's wrapper
computes its plain version and launches nothing. Tolerances are
test_ops.py's: f32 leaf log-probs within 1e-4; bf16 W compared as
probabilities within 1e-2 relative."""

import numpy as np
import pytest
import torch

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)


def _inputs(ta, D, batch=12, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(D, ta.num_classes).astype(np.float32)
    b = rng.randn(ta.num_classes).astype(np.float32)
    feats = rng.randn(batch, D).astype(np.float32)
    return feats, W, b


def _run_both(name, D, bf16, want_aux, batch=12):
    import jax.numpy as jnp

    from nbdt_tpu.ops import soft_traversal as jst
    from nbdt_torch.ops import soft_traversal as tst

    jtree, ttree = tree_pair(name)
    feats, W, b = _inputs(ttree.arrays, D, batch)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jhc = jst.prepare_head_constants(jtree.arrays, W, b, dtype=jdt)
    j = jst.fused_soft_head(jnp.asarray(feats, jdt), jhc, block_b=8,
                            interpret=True, want_aux=want_aux)
    thc = tst.prepare_head_constants(ttree.arrays, W, b, dtype=tdt, device="cpu")
    before = tst.launches
    t = tst.fused_soft_head(torch.as_tensor(feats).to(tdt), thc, want_aux=want_aux)
    assert tst.launches == before == 0  # the CPU takes the plain version
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("want_aux", [True, False], ids=["aux", "leaf"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["synthetic", "CIFAR10"])
def test_head_matches_pallas_interpret(name, bf16, want_aux):
    D = 16 if name == "synthetic" else 512
    j, t = _run_both(name, D, bf16, want_aux)
    assert len(j) == len(t) == (3 if want_aux else 1)
    if bf16:
        np.testing.assert_allclose(np.exp(t[0]), np.exp(j[0]), rtol=1e-2, atol=1e-4)
    else:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t[0].argmax(1), j[0].argmax(1))
    if want_aux:
        np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-4)
        # node-major [B, N*K] with padded slots at -1e30 on both sides
        assert t[2].shape == j[2].shape
        np.testing.assert_allclose(t[2], j[2], rtol=1e-4, atol=1e-4)


def test_head_matches_pallas_interpret_imagenet1000():
    """A 1000-class tree: the TPU kernel streams node chunks; the port loops."""
    j, t = _run_both("Imagenet1000", 32, False, False, batch=8)
    np.testing.assert_allclose(np.exp(t[0]), np.exp(j[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(t[0].argmax(1), j[0].argmax(1))


@pytest.mark.parametrize("name", ["CIFAR100", "dag"])
def test_head_constants_equal_dense_layout(name):
    """The compact slot and class lists describe exactly the dense
    membership and `under` matrices (every containing slot on a DAG)."""
    from nbdt_torch.ops.soft_traversal import prepare_head_constants

    _, tree = tree_pair(name)
    ta = tree.arrays
    N, K, C = ta.membership.shape
    hc = prepare_head_constants(ta, np.zeros((4, C), np.float32), device="cpu")
    ptr, cls, w = hc.slot_ptr.numpy(), hc.slot_cls.numpy(), hc.slot_w.numpy()
    membership = np.zeros((N * K, C), np.float32)
    for s in range(N * K):
        membership[s, cls[ptr[s]:ptr[s + 1]]] = w[ptr[s]:ptr[s + 1]]
    np.testing.assert_array_equal(membership, ta.membership.reshape(N * K, C))
    cptr, slot = hc.class_ptr.numpy(), hc.class_slot.numpy()
    under = np.zeros((C, N * K), np.float32)
    for c in range(C):
        under[c, slot[cptr[c]:cptr[c + 1]]] = 1.0
    np.testing.assert_array_equal(under.T, ta.under.reshape(N * K, C))
    np.testing.assert_array_equal(hc.slot_valid.numpy().astype(bool), ta.child_mask.reshape(-1))


def test_head_rejects_wrong_width():
    from nbdt_torch.ops.soft_traversal import fused_soft_head, prepare_head_constants

    _, tree = tree_pair("synthetic")
    hc = prepare_head_constants(tree.arrays, np.zeros((16, 7), np.float32), device="cpu")
    with pytest.raises(ValueError, match="feats must be"):
        fused_soft_head(torch.zeros(3, 15), hc)
