"""The port's host-side continual learning (`repro_torch.core.continual`,
`repro_torch.core.distill`, `learn.loop.finetune_update` /
`init_finetune_state`) against the JAX package's on the same seeded
inputs.

Tolerances: the replay bookkeeping (`balanced_counts`,
`sample_balanced` with its RandomState(0) draw), `teacher_labels`,
`rank_agreement` and `spearman` exactly equal; over 3 `finetune_update`
steps the loss within 1e-5 relative and the parameters within 1e-6
(float32 convolutions and sums in another order, as
tests/test_torch_learn.py holds distillation), the backbone bit-equal
to what it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DEFAULT_GRID as JGRID  # noqa: E402
from repro.core import continual as jcont  # noqa: E402
from repro.core import distill as jdist  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro_torch.core import DEFAULT_GRID as TGRID  # noqa: E402
from repro_torch.core import continual as tcont  # noqa: E402
from repro_torch.core import distill as tdist  # noqa: E402
from repro_torch.learn.loop import finetune_update  # noqa: E402
from repro_torch.learn.loop import init_finetune_state  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

CFG = get_smoke_config("madeye-approx")


@pytest.mark.parametrize("latest", [0, 12, 24])
def test_balanced_counts_match_jax(latest):
    rng = np.random.default_rng(latest)
    for counts in (rng.integers(0, 5, TGRID.n_cells),
                   np.zeros(TGRID.n_cells, int)):
        for pad_hops, decay in ((3, 0.5), (1, 0.3)):
            got = tcont.balanced_counts(counts, latest, TGRID,
                                        pad_hops=pad_hops, decay=decay)
            want = jcont.balanced_counts(counts, latest, JGRID,
                                         pad_hops=pad_hops, decay=decay)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("max_total", [8, 256])
def test_replay_buffer_and_sample_balanced_match_jax(max_total):
    """Past max_total the seeded RandomState(0) subset is drawn alike."""
    bufs = (tcont.ReplayBuffer(TGRID.n_cells, capacity_per_cell=4),
            jcont.ReplayBuffer(JGRID.n_cells, capacity_per_cell=4))
    rng = np.random.default_rng(2)
    for i in range(60):
        cell = int(rng.integers(0, TGRID.n_cells))
        for b in bufs:
            b.add(cell, (i, cell))
    assert bufs[0].store == bufs[1].store
    assert all(bufs[0].count(c) == bufs[1].count(c) <= 4
               for c in range(TGRID.n_cells))
    window = rng.integers(0, 3, TGRID.n_cells)
    got = tcont.sample_balanced(bufs[0], window, 7, TGRID,
                                max_total=max_total)
    want = jcont.sample_balanced(bufs[1], window, 7, JGRID,
                                 max_total=max_total)
    assert got == want and len(got) == min(max_total, len(want)) > 0


def test_teacher_labels_and_rank_metrics_match_jax():
    rng = np.random.default_rng(0)
    boxes = [rng.uniform(0, 1, (k, 4)) for k in (0, 3, 12, 40)]
    classes = [rng.integers(0, 2, b.shape[0]) for b in boxes]
    got = tdist.teacher_labels(boxes, classes, 8)
    want = jdist.teacher_labels(boxes, classes, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for _ in range(5):
        p, q = rng.random(6), rng.random(6)
        assert tdist.rank_agreement(p, q) == jdist.rank_agreement(p, q)
        assert tdist.spearman(p, q) == jdist.spearman(p, q)
    assert tdist.spearman(np.zeros(1), np.zeros(1)) == 1.0


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(0.5, 0.2, (b, CFG.img_res, CFG.img_res, 3)).astype(
        np.float32)
    tb = [np.array([[0.2 + 0.15 * i, 0.4, 0.2, 0.3],
                    [0.7, 0.1 + 0.2 * i, 0.1, 0.1]]) for i in range(b)]
    tc = [np.array([i % 2, 1]) for i in range(b)]
    return imgs, tdist.teacher_labels(tb, tc, CFG.max_boxes)


def test_finetune_update_matches_jax():
    jp = jdet.detector_init(jax.random.PRNGKey(0), CFG)
    tp = tdet.params_from_numpy(jax.tree.map(np.asarray, jp))
    backbone0 = [x.clone() for x in tree_leaves(tp["backbone"])]
    heads0 = [x.clone() for x in tree_leaves(tp["heads"])]
    imgs, tgt = _batch()
    jopt, topt = jcont.init_finetune(jp), tcont.init_finetune(tp)
    for a, b in zip(jax.tree.leaves(jopt.mu), tree_leaves(topt.mu)):
        assert np.asarray(a).shape == tuple(b.shape)
    jargs = [jnp.asarray(x) for x in (imgs, *tgt)]
    targs = [torch.as_tensor(x) for x in (imgs, *tgt)]
    for step in range(3):
        jp, jopt, jloss = jcont.finetune_step(jp, jopt, CFG, *jargs,
                                              lr=3e-3)
        tp, topt, tloss = tcont.finetune_step(tp, topt, CFG, *targs,
                                              lr=3e-3)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=0, err_msg=f"step {step}")
    assert int(topt.step) == 3
    # the backbone is frozen: bit-equal, and the heads moved
    assert all(torch.equal(a, b)
               for a, b in zip(backbone0, tree_leaves(tp["backbone"])))
    assert not any(torch.equal(a, b)
                   for a, b in zip(heads0, tree_leaves(tp["heads"])))


def test_finetune_reduces_loss_heads_only():
    """The reference's tests/test_continual_learning.py criterion on the
    port: the loss falls by 10% over 12 steps; init_finetune_state keeps
    moments for the heads only."""
    tp = tdet.detector_init(torch.Generator().manual_seed(0), CFG)
    opt = init_finetune_state(tp)
    assert all(m.dim() == 0 for m in tree_leaves(opt.mu["backbone"]))
    imgs, tgt = _batch(8, seed=1)
    args = [torch.as_tensor(x) for x in (imgs, *tgt)]
    losses = []
    for _ in range(12):
        tp, opt, loss = finetune_update(tp, opt, CFG, *args, lr=3e-3)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
