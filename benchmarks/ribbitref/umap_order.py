"""libstdc++ unordered_map iteration-order simulation.

The reference iterates `unordered_map` in two output-affecting places
(parse_smallmotif_seed.cpp:177-187 emission order; the factor vote sorts
after collecting, so only the first matters).  To reproduce BED line order
bit-for-bit we simulate libstdc++'s _Hashtable layout for integer keys
(identity hash, max_load_factor 1.0):

  * one global singly-linked node list with a before-begin sentinel;
    buckets store the node *preceding* the bucket's first node
  * inserting into an occupied bucket places the node at the bucket front;
    a fresh bucket's node goes to the global list front
  * rehash walks the list in iteration order re-inserting each node
    (reversing runs of fresh buckets)
  * growth: need = size+1 > next_resize; new count = smallest table prime
    >= max(size+2, 2*buckets) with first resize to >= 12 -> 13

Validated empirically against g++ 12 (tests/test_umap_order.py).

The benchmark's frozen copy of the repository's umap_order.py spec.
"""

from __future__ import annotations

from bisect import bisect_left

# __prime_list from libstdc++ (growth path actually exercised; extended on
# demand by _next_table_prime for sizes beyond the cached prefix)
_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
           67, 71, 73, 79, 83, 89, 97, 103, 109, 113, 127, 137, 139, 149, 157,
           167, 179, 193, 199, 211, 227, 241, 257, 277, 293, 313, 337, 359,
           383, 409, 439, 467, 503, 541, 577, 619, 661, 709, 761, 823, 887,
           953, 1031, 1109, 1193, 1289, 1381, 1493, 1613, 1741, 1879, 2029,
           2179, 2357, 2549, 2753, 2971, 3209, 3469, 3739, 4027, 4349, 4703,
           5087, 5503, 5953, 6427, 6949, 7517, 8123, 8783, 9497, 10273, 11113,
           12011, 12983, 14033, 15173, 16411, 17749, 19183, 20753, 22447,
           24281, 26267, 28411, 30727, 33223, 35933, 38873, 42043, 45481,
           49201, 53201, 57557, 62233, 67307, 72817, 78779, 85229, 92203,
           99733, 107897, 116731, 126271, 136607, 147793, 159871, 172933,
           187091, 202409, 218971, 236897, 256279, 277261, 299951, 324503,
           351061, 379787, 410857, 444487, 480881, 520241, 562841, 608903,
           658753, 712697, 771049, 834181, 902483, 976369]


def _next_table_prime(n: int) -> int:
    i = bisect_left(_PRIMES, n)
    if i < len(_PRIMES):
        return _PRIMES[i]
    # beyond the cached prefix of the table; extend with the growth ratio
    # libstdc++ uses (~1.08x) — sizes this large do not occur per seed
    x = n if n % 2 else n + 1
    while True:
        for d in range(3, int(x ** 0.5) + 1, 2):
            if x % d == 0:
                break
        else:
            return x
        x += 2


class _Node:
    __slots__ = ("key", "nxt")

    def __init__(self, key: int):
        self.key = key
        self.nxt = None


def libstdcxx_order(keys_in_insertion_order: list[int]) -> list[int]:
    """Iteration order of a libstdc++ unordered_map<uintN, V> after inserting
    the given distinct keys in order (identity hash)."""
    sentinel = _Node(-1)
    buckets: dict[int, _Node] = {}   # bucket -> node before bucket's first
    nbkt = 1
    next_resize = 0
    size = 0

    def bucket_of_front() -> int:
        return sentinel.nxt.key % nbkt if sentinel.nxt is not None else -1

    def rehash(new_nbkt: int):
        nonlocal nbkt, buckets
        nbkt = new_nbkt
        buckets = {}
        p = sentinel.nxt
        sentinel.nxt = None
        bbegin_bkt = -1
        while p is not None:
            nxt = p.nxt
            b = p.key % nbkt
            before = buckets.get(b)
            if before is None:
                p.nxt = sentinel.nxt
                sentinel.nxt = p
                buckets[b] = sentinel
                if p.nxt is not None:
                    buckets[bbegin_bkt] = p
                bbegin_bkt = b
            else:
                p.nxt = before.nxt
                before.nxt = p
            p = nxt

    for key in keys_in_insertion_order:
        # _Prime_rehash_policy::_M_need_rehash(nbkt, size, 1)
        if size + 1 > next_resize:
            min_bkts = max(size + 1, 11 if next_resize == 0 else 0)
            if min_bkts >= nbkt:
                rehash(_next_table_prime(max(min_bkts + 1, nbkt * 2)))
                next_resize = nbkt  # floor(nbkt * max_load_factor(1.0))
            else:
                next_resize = nbkt

        b = key % nbkt
        node = _Node(key)
        before = buckets.get(b)
        if before is not None:
            node.nxt = before.nxt
            before.nxt = node
        else:
            front_bkt = bucket_of_front()
            node.nxt = sentinel.nxt
            sentinel.nxt = node
            if node.nxt is not None:
                buckets[front_bkt] = node
            buckets[b] = sentinel
        size += 1

    out = []
    p = sentinel.nxt
    while p is not None:
        out.append(p.key)
        p = p.nxt
    return out
