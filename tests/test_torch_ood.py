"""The port's OOD scorers and thresholds (``tpuhar_torch/ood.py``) and ``auroc``
(``tpuhar_torch/eval/metrics.py``) vs ``tpuhar.ood`` and ``tpuhar.eval.metrics`` on
the same numpy embeddings.

Tolerances: the fitted arrays (means, precisions, the KNN bank) are the same float64
(or f32) host computation rounded to f32: 1e-6 relative of each array's largest
entry; scores 1e-4 relative (f32 products in another order); thresholds, FPR and AUROC
are the same numpy code on the same scores: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar import ood as J
from tpuhar.eval.metrics import auroc as jax_auroc
from tpuhar_torch import ood as T
from tpuhar_torch.eval.metrics import auroc

FIT_RTOL = 1e-6
SCORE_RTOL = 1e-4
D, C = 16, 4


def _data(n, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, n)
    centers = rng.normal(0, 3, (C, D))
    emb = (centers[labels] + rng.normal(0, 1, (n, D)) + shift).astype(np.float32)
    return emb, labels


def _close_arrays(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["mahalanobis", "rmd"])
def test_mahalanobis_fit_and_score(name):
    emb, labels = _data(200, 0)
    test = np.concatenate([_data(20, 1)[0], _data(20, 2, shift=4.0)[0]])
    fit = {"mahalanobis": (T.MahalanobisScorer, J.MahalanobisScorer), "rmd": (T.RelativeMahalanobisScorer, J.RelativeMahalanobisScorer)}
    ours, theirs = (cls.fit(emb, labels, C) for cls in fit[name])
    fields = ("means", "precision") + (("mean0", "precision0") if name == "rmd" else ())
    for field in fields:
        _close_arrays(getattr(ours, field), getattr(theirs, field))
    got = ours.score(test)
    assert got.dtype == torch.float32 and got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.score(jnp.asarray(test))), rtol=SCORE_RTOL, atol=0)
    # a torch input, and the scorer moved to the device it already is on, score alike
    torch.testing.assert_close(ours.to("cpu").score(torch.from_numpy(test)), got, rtol=0, atol=0)


@pytest.mark.parametrize("n,max_bank,k", [(50, 20000, 5), (300, 64, 10), (30, 20000, 99)])
def test_knn_fit_and_score(n, max_bank, k):
    """The bank subsampled (``max_bank`` < N) with the reference's seeded draw, and
    ``k`` cut to the bank's size."""
    emb, _ = _data(n, 3)
    test = np.concatenate([_data(10, 4)[0], _data(10, 5, shift=5.0)[0]])
    ours = T.KNNScorer.fit(emb, k=k, max_bank=max_bank, seed=7)
    theirs = J.KNNScorer.fit(emb, k=k, max_bank=max_bank, seed=7)
    assert ours.k == theirs.k == min(k, n, max_bank)
    _close_arrays(ours.bank, theirs.bank)
    got = ours.score(test).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs.score(jnp.asarray(test))), rtol=SCORE_RTOL, atol=0)
    assert (got >= 0).all()


def test_compute_ood_scores():
    emb, labels = _data(120, 6)
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (25, C)).astype(np.float32)
    test = _data(25, 7, shift=2.0)[0]
    scorers = {
        pkg: dict(
            mahalanobis=m.MahalanobisScorer.fit(emb, labels, C), knn=m.KNNScorer.fit(emb, k=5),
            rmd=m.RelativeMahalanobisScorer.fit(emb, labels, C),
        )
        for pkg, m in (("port", T), ("jax", J))
    }
    every = ["msp", "energy", "mahalanobis", "knn", "rmd"]
    for scores in (None, every, ["msp", "knn"]):
        got = T.compute_ood_scores(logits, test, energy_temperature=2.0, scores=scores, **scorers["port"])
        want = J.compute_ood_scores(logits, test, energy_temperature=2.0, scores=scores, **scorers["jax"])
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == np.float32 and got[key].shape == (25,), key
            np.testing.assert_allclose(got[key], value, rtol=SCORE_RTOL, atol=1e-6, err_msg=key)
    # without embeddings only the logit scores
    assert set(T.compute_ood_scores(logits, None, scores=every, **scorers["port"])) == {"msp", "energy"}


def test_fit_ood_thresholds():
    rng = np.random.default_rng(8)
    scores = {"msp": np.linspace(0.0, 1.0, 101), "energy": rng.normal(size=57).astype(np.float32)}
    for fpr in (0.05, 0.1, 0.5):
        assert T.fit_ood_thresholds(scores, id_fpr=fpr) == J.fit_ood_thresholds(scores, id_fpr=fpr)
    assert abs(T.fit_ood_thresholds(scores)["msp"] - 0.95) < 1e-9
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError, match="id_fpr"):
            T.fit_ood_thresholds(scores, id_fpr=bad)


def test_fpr_at_tpr():
    rng = np.random.default_rng(9)
    s = np.concatenate([rng.normal(0, 1, 80), rng.normal(1.5, 1, 40)])
    is_ood = np.r_[np.zeros(80), np.ones(40)]
    for tpr in (0.8, 0.95):
        assert T.fpr_at_tpr(s, is_ood, tpr) == J.fpr_at_tpr(s, is_ood, tpr)
    assert np.isnan(T.fpr_at_tpr(s, np.zeros(120)))


def test_auroc_with_ties():
    rng = np.random.default_rng(10)
    for scores, labels in (
        (rng.normal(size=200), rng.integers(0, 2, 200)),
        (rng.integers(0, 5, 200).astype(np.float64), rng.integers(0, 2, 200)),  # many ties
        (np.array([0.1, 0.4, 0.4, 0.8, 0.8, 0.8]), np.array([0, 0, 1, 0, 1, 1])),
    ):
        assert auroc(scores, labels) == jax_auroc(scores, labels)
    assert auroc([0.5, 0.5], [1, 1]) != auroc([0.5, 0.5], [1, 1])  # nan: one class only
    assert auroc([1.0, 2.0, 3.0], [0, 1, 1]) == 1.0
