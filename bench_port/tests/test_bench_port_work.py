"""The work counts against counts made by hand at tiny shapes."""
from bench_port import peaks
from bench_port.work import trees


def test_tree_bytes():
    # depth 2: 3 inner nodes of 4 + 4 + 1 bytes, 4 leaves of 1 float
    assert trees.tree_bytes(2, 1) == 3 * 9 + 4 * 4


def test_walk():
    ops, byt = trees.walk(n=2, features=3, trees=4, depth=2, outputs=1)
    assert ops == 2 * 4 * (2 + 2)           # 2 compares, 1 multiply-add
    assert byt == 2 * (3 + 1) * 4 + 4 * 43


def test_fit():
    ops, byt = trees.fit(n=4, features=1, bins=2, outputs=1, depth=1,
                         oblivious=False)
    hand = (4 * 2             # sort: 4 rows x log2 4
            + 4 * 2           # bucket search: log2 3 -> 2
            + 4 * 2           # one histogram: 4 rows x (1 output + count)
            + 3 * 2           # prefix sums: 3 buckets x 2 columns
            + 2 * 13          # 2 candidates x (6 * 1 + 7)
            + 2               # argmax
            + 4               # routing
            + 4 * 2 + 2)      # leaf sums and 2 means
    assert ops == hand
    assert byt == 4 * 3 * 4 + (9 + 2 * 4)
    ops_obl, _ = trees.fit(n=4, features=1, bins=2, outputs=1, depth=1,
                           oblivious=True)
    assert ops_obl == hand + 2              # the sum over the level's nodes


def test_least_seconds():
    assert peaks.least_seconds(67e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0
    assert peaks.least_seconds(67e12, 6.7e12) == 2.0
