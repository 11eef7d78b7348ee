"""Selection-network generator tests: exactness of the min/max medians."""

import numpy as np
import pytest

from dips.ops import networks


@pytest.mark.parametrize("n", list(range(1, 17)) + [25, 49])
def test_sorting_network_sorts(n):
    r = np.random.default_rng(n)
    for _ in range(20):
        x = r.standard_normal(n).astype(np.float32)
        vals = list(x)
        out = networks.apply_network(
            vals, [(i, j, True, True) for i, j in networks.sorting_network(n)],
            np.minimum, np.maximum)
        np.testing.assert_array_equal(np.array(out), np.sort(x))


@pytest.mark.parametrize("n", list(range(1, 17)) + [25, 49])
def test_median_network_exact(n):
    r = np.random.default_rng(100 + n)
    # vector planes, duplicates included (uint8-like values)
    x = r.integers(0, 8, (n, 64)).astype(np.float32)
    med = networks.median_of(list(x), np.minimum, np.maximum)
    expected = np.sort(x, axis=0)[n // 2]
    np.testing.assert_array_equal(med, expected)


def test_pruning_shrinks_network():
    full = networks.sorting_network(49)
    pruned = networks.median_network(49)
    assert len(pruned) < len(full)
    # and single-sided ops exist (min-only or max-only)
    assert any(not (m and M) for (_, _, m, M) in pruned)


@pytest.mark.parametrize("w", [3, 5, 7])
def test_column_median_plan_exact(w):
    """Column-factored rank-pruned plan == brute-force window median."""
    r = np.random.default_rng(w)
    h, wd, p = 10, 18, w // 2
    plane = r.integers(0, 5, (h + 2 * p, wd)).astype(np.float32)
    vtaps = [plane[dy:dy + h] for dy in range(w)]

    def shift(x, dx):
        out = np.zeros_like(x)
        if dx == 0:
            return x.copy()
        if dx > 0:
            out[:, :-dx] = x[:, dx:]
        else:
            out[:, -dx:] = x[:, :dx]
        return out

    got = networks.window_median(vtaps, shift, np.minimum, np.maximum)
    padded = np.zeros((h + 2 * p, wd + 2 * p), np.float32)
    padded[:, p:p + wd] = plane
    exp = np.empty((h, wd), np.float32)
    for y in range(h):
        for x in range(wd):
            exp[y, x] = np.sort(padded[y:y + w, x:x + w].ravel())[(w * w) // 2]
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("w", [3, 5, 7])
def test_column_plan_cheaper_than_flat(w):
    _, mo, _ = networks.column_median_plan(w)
    new_ops = sum((1 if m else 0) + (1 if M else 0) for _, _, m, M in mo)
    old_ops = sum((1 if m else 0) + (1 if M else 0)
                  for _, _, m, M in networks.median_network(w * w))
    assert new_ops < old_ops
