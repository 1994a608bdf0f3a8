"""The benchmark's references, comparisons, control and frozen generators
against plain numpy and the program's own generators, at small sizes."""
import numpy as np
import pytest
import torch

from portbench.reference import generators as gen
from portbench.reference.join import (capped_repartition_pairs,
                                      compare_join, output_capacity,
                                      reference_pairs)
from portbench.reference.sort import compare_sort, reference_sort


def _records(t=4, m=257, seed=5, zipf=False):
    keys = (gen.zipf_keys(t * m, seed=seed) if zipf
            else gen.uniform_keys(t * m, seed=seed)).reshape(t, m)
    x = torch.from_numpy(keys)
    return x, gen.make_payload(t, m, seed, 24, device="cpu")


@pytest.mark.parametrize("zipf", [False, True])
def test_reference_sort_is_numpy_stable_sort(zipf):
    x, v = _records(zipf=zipf)
    keys, rows = reference_sort(x, v)
    order = np.argsort(x.numpy().reshape(-1), kind="stable")
    assert np.array_equal(keys.numpy(), np.sort(x.numpy().reshape(-1)))
    assert np.array_equal(rows.numpy(), v.numpy().reshape(-1, 24)[order])
    # payload column 0 is the row id: equal keys keep row-major order
    ids = rows[:, 0].numpy()
    same = keys.numpy()[1:] == keys.numpy()[:-1]
    assert (ids[1:][same] > ids[:-1][same]).all()


def test_compare_sort_counts_each_fault():
    x, v = _records(zipf=True)
    keys, rows = reference_sort(x, v)
    assert compare_sort(x, v, keys, rows) == {"keys_wrong": 0, "rows_wrong": 0}
    bad = rows.clone()
    bad[10, 3] ^= 1
    assert compare_sort(x, v, keys, bad) == {"keys_wrong": 0, "rows_wrong": 1}
    # an unstable answer: two equal keys' records swapped
    same = np.nonzero(keys.numpy()[1:] == keys.numpy()[:-1])[0][0]
    swapped = rows.clone()
    swapped[[same, same + 1]] = swapped[[same + 1, same]]
    assert compare_sort(x, v, keys, swapped)["rows_wrong"] == 2
    assert compare_sort(x, v, keys[:-5], rows[:-5]) == {"keys_wrong": 5,
                                                         "rows_wrong": 5}
    assert compare_sort(x, v, keys, None)["rows_wrong"] == keys.shape[0]


@pytest.mark.parametrize("zipf", [False, True])
def test_sort_control_fails(zipf):
    """Keys compared in bfloat16 put float32 keys out of order."""
    x, v = _records(t=8, m=1024, zipf=zipf)
    keys, rows = reference_sort(x, v, torch.bfloat16)
    numbers = compare_sort(x, v, keys, rows)
    assert numbers["keys_wrong"] > 0 and numbers["rows_wrong"] > 0


def _brute_pairs(s, t):
    return sorted(i * len(t) + j for i in range(len(s)) for j in range(len(t))
                  if s[i] == t[j])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_pairs_is_the_brute_force_join(seed):
    s, t = gen.zipf_tables(300, 200, theta=0.3, seed=seed, domain=40)
    assert reference_pairs(s, t).tolist() == _brute_pairs(s, t)


def test_compare_join_counts_each_fault():
    s, t = gen.zipf_tables(500, 400, theta=0.5, seed=3, domain=60)
    codes = torch.from_numpy(reference_pairs(s, t))
    n_t = len(t)
    sr, tr = codes // n_t, codes % n_t
    ok = torch.ones_like(codes, dtype=torch.bool)
    assert compare_join(s, t, sr, tr, ok) == {
        "pairs_missing": 0, "pairs_wrong": 0, "pairs_repeated": 0}
    # slots in another order and padded slots do not matter
    perm = torch.randperm(codes.shape[0], generator=torch.Generator()
                          .manual_seed(0))
    pad = torch.zeros(7, dtype=torch.long)
    assert compare_join(s, t, torch.cat([sr[perm], pad]),
                        torch.cat([tr[perm], pad]),
                        torch.cat([ok, torch.zeros(7, dtype=torch.bool)])
                        )["pairs_missing"] == 0
    drop = ok.clone()
    drop[:3] = False
    assert compare_join(s, t, sr, tr, drop)["pairs_missing"] == 3
    wrong = tr.clone()
    wrong[0] = (wrong[0] + 1) % n_t
    got = compare_join(s, t, sr, wrong, ok)
    assert got["pairs_wrong"] >= 1 and got["pairs_missing"] >= 1
    twice = compare_join(s, t, torch.cat([sr, sr[:4]]),
                         torch.cat([tr, tr[:4]]),
                         torch.ones(codes.shape[0] + 4, dtype=torch.bool))
    assert twice == {"pairs_missing": 0, "pairs_wrong": 0,
                     "pairs_repeated": 4}


def test_join_control_drops_on_skew():
    s, t = gen.zipf_tables(4096, 4096, theta=0.5, seed=3)
    kept = capped_repartition_pairs(s, t, 64)
    full = reference_pairs(s, t)
    assert np.isin(kept, full).all()
    assert len(full) - len(kept) > 0
    assert output_capacity(len(full), 64) == int(np.ceil(1.05 * 2 * len(full) / 64))


def test_generators_equal_the_programs():
    from repro_torch.data import synthetic
    from repro_torch.workloads import make_payload
    for seed in (0, 7, 2**31 + 5):
        assert np.array_equal(gen.uniform_keys(1000, seed),
                              synthetic.uniform_keys(1000, seed))
        assert np.array_equal(gen.zipf_keys(1000, seed),
                              synthetic.zipf_keys(1000, seed))
        for a, b in zip(gen.zipf_tables(500, 300, 0.5, seed),
                        synthetic.zipf_tables(500, 300, 0.5, seed)):
            assert np.array_equal(a, b)
        s32 = gen.sub_seed(seed, 1, 1)
        assert torch.equal(gen.make_payload(4, 64, s32, 24, device="cpu"),
                           make_payload(4, 64, s32, device="cpu"))


def test_sub_seed_takes_large_seeds():
    seeds = {gen.sub_seed(s, i, k) for s in (0, 2**31 + 1, 2**40 + 3)
             for i in range(2) for k in range(3)}
    assert len(seeds) == 18
    assert all(0 <= s < 2**32 for s in seeds)
    assert gen.sub_seed(2**33, 0, 0) == gen.sub_seed(2**33, 0, 0)
