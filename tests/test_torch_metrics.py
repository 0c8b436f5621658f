"""The port's ``classification_metrics`` against the reference's.

Top-1 takes the first maximum in both packages. Top-5 membership must
follow ``jax.lax.top_k``, which orders equal values by index and every
float by XLA's total order (``-NaN < -inf < ... < -0.0 < +0.0 < ... <
+inf < +NaN``). The metrics are counts, so ``error`` and ``top5_error``
must be exactly equal: tolerance zero. The inputs are tie-heavy rows,
bf16-rounded logits over 1000 classes (ties among 1000 values rounded to
8 bits are common), NaNs of both signs at the label and elsewhere,
signed zeros, and fewer than 5 classes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.models.contract import classification_metrics as j_metrics
from theanompi_tpu_torch.models.contract import classification_metrics as t_metrics

NEG_NAN = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]


def _tie_rows(n_classes=10):
    """``[1, 1, 1, 0, ..., 0]`` with each label, and rows of a few levels."""
    rows, labels = [], []
    for y in range(n_classes):
        rows.append([1.0, 1.0, 1.0] + [0.0] * (n_classes - 3))
        labels.append(y)
    r = np.random.RandomState(0)
    for _ in range(200):
        rows.append(list(r.randint(0, 3, n_classes).astype(np.float32)))
        labels.append(int(r.randint(n_classes)))
    return np.asarray(rows, np.float32), np.asarray(labels, np.int32)


def _bf16_rows(n=6400, n_classes=1000, seed=1):
    """N(0, 0.03^2) logits rounded to bf16, as a bf16 head rounds them."""
    r = np.random.RandomState(seed)
    x = (r.randn(n, n_classes) * 0.03).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x, r.randint(0, n_classes, n).astype(np.int32)


def _special_rows():
    """NaN (both signs) at the label and elsewhere, infinities, signed zeros."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    base = [0.5, 0.25, 0.25, 0.0, -0.0, -1.0, 2.0, 0.25]
    rows, labels = [], []

    def add(row, y):
        rows.append(row)
        labels.append(y)

    for y in range(8):
        add(list(base), y)
        for i, v in ((6, nan), (0, NEG_NAN), (3, inf), (5, -inf), (y, nan), (y, NEG_NAN)):
            row = list(base)
            row[i] = v
            add(row, y)
        add([0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0], y)
        add([-0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0], y)
        add([nan, nan, nan, nan, nan, nan, 0.0, 1.0], y)
        add([NEG_NAN] * 6 + [-inf, -inf], y)
    return np.asarray(rows, np.float32), np.asarray(labels, np.int32)


def _few_classes():
    r = np.random.RandomState(2)
    x = r.randint(0, 2, (64, 3)).astype(np.float32)
    return x, r.randint(0, 3, 64).astype(np.int32)


CASES = {"ties": _tie_rows, "bf16 logits over 1000 classes": _bf16_rows,
         "NaN, inf and signed zeros": _special_rows, "3 classes": _few_classes}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_equal_the_reference_exactly(case):
    x, y = CASES[case]()
    want = j_metrics(jnp.asarray(x), jnp.asarray(y))
    got = t_metrics(torch.from_numpy(x), torch.from_numpy(y).long())
    for name in ("error", "top5_error"):
        assert float(got[name]) == float(want[name]), (case, name, float(got[name]),
                                                       float(want[name]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_top5_membership_row_by_row(case):
    """Each row's membership, not only the mean: a miss on one row and a
    false hit on another would cancel in the metric."""
    x, y = CASES[case]()
    k = min(5, x.shape[1])
    import jax

    idx = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    want = (idx == y[:, None]).any(axis=1)
    for i in range(0, len(x), 64):  # row by row through the port's own metric
        xs, ys = torch.from_numpy(x[i:i + 64]), torch.from_numpy(y[i:i + 64]).long()
        got = torch.stack([1.0 - t_metrics(xs[j:j + 1], ys[j:j + 1])["top5_error"]
                           for j in range(len(xs))]).numpy() == 1.0
        np.testing.assert_array_equal(got, want[i:i + 64], err_msg=f"{case} rows {i}+")


def test_torch_topk_control_sees_the_fault():
    """``torch.topk``'s membership (the port's old rule) differs from the
    reference on the tie rows, so the tests above can see the fault."""
    x, y = _tie_rows()
    t = torch.from_numpy(x)
    old = (torch.topk(t, 5, dim=-1).indices == torch.from_numpy(y).long()[:, None]).any(-1)
    want = j_metrics(jnp.asarray(x), jnp.asarray(y))["top5_error"]
    assert float(1.0 - old.float().mean()) != float(want)
