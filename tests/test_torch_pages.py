"""The port's page pool against the reference's, op for op.

`repro_torch.serving.pages.PagePool` is a copy of the reference's host
bookkeeping. Both pools run the same seeded random sequences of alloc /
release / retain / intern / lookup / ensure_private in lockstep (the
operation mix of `tests/test_paged.py::_random_pool_ops`), and after every
operation the returned page ids, the refcounts of every page, `PageStats`,
the exception raised (if any) and `check_invariants` must agree. Then the
pool's own contract: the zero page is never handed out and exhaustion is
loud.
"""
import dataclasses
import random

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro.serving import pages as jpages
from repro_torch.serving import pages as tpages


def _call(pool, op, *args):
    try:
        return getattr(pool, op)(*args), None
    except (jpages.PagePoolExhausted, tpages.PagePoolExhausted,
            ValueError) as e:
        return None, type(e).__name__


def _lockstep(seed: int, num_ops: int = 120):
    rnd = random.Random(seed)
    size = rnd.randint(3, 12)
    ref, port = jpages.PagePool(size), tpages.PagePool(size)
    held, keys, ops = {}, [], 0
    for _ in range(num_ops):
        op = rnd.choice(["alloc", "alloc", "release", "retain", "intern",
                         "lookup", "ensure_private", "release_any"])
        if op == "alloc":
            args = ()
        elif op == "lookup" and keys:
            args = (rnd.choice(keys),)
        elif op == "intern" and held:
            pid = rnd.choice(sorted(held))
            if pid in ref._by_pid:
                continue  # one key per page (the index is a bijection)
            key = b"prefix-%d" % len(keys)
            keys.append(key)
            args = (key, pid)
        elif op == "release_any":  # an unreferenced page: raises
            free = [p for p in range(1, size) if ref.refs(p) == 0]
            if not free:
                continue
            op, args = "release", (rnd.choice(free),)
        elif op in ("release", "retain", "ensure_private") and held:
            args = (rnd.choice(sorted(held)),)
        else:
            continue
        want, want_exc = _call(ref, op, *args)
        got, got_exc = _call(port, op, *args)
        ops += 1
        assert (got, got_exc) == (want, want_exc), (op, args)
        if want_exc is None:
            if op == "alloc" or (op == "lookup" and want is not None):
                held[want] = held.get(want, 0) + 1
            elif op == "retain":
                held[args[0]] += 1
            elif op == "release" and args[0] in held:
                held[args[0]] -= 1
            elif op == "ensure_private" and want[1] is not None:
                held[args[0]] -= 1
                held[want[0]] = held.get(want[0], 0) + 1
            held = {p: n for p, n in held.items() if n > 0}
        assert [port.refs(p) for p in range(size)] == \
            [ref.refs(p) for p in range(size)]
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(
            ref.stats)
        assert (port.in_use(), port.free_pages()) == (ref.in_use(),
                                                      ref.free_pages())
        ref.check_invariants()
        port.check_invariants()
    return ops


@pytest.mark.parametrize("seed", range(12))
def test_pool_matches_reference_op_for_op(seed):
    assert _lockstep(seed) > 60


def test_pool_zero_page_and_exhaustion():
    pool = tpages.PagePool(3)
    assert pool.refs(tpages.ZERO_PAGE) == 1
    a, b = pool.alloc(), pool.alloc()
    assert tpages.ZERO_PAGE not in (a, b)
    with pytest.raises(tpages.PagePoolExhausted):
        pool.alloc()
    pool.intern(b"k", a)
    pool.release(a)  # index-only now: evictable
    assert pool.alloc() == a and pool.stats.evictions == 1
    with pytest.raises(ValueError, match="at least|>= 2"):
        tpages.PagePool(1)
