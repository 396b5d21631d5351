"""Emulated single-word atomics for the host-plane reclamation schemes.

The paper's algorithms are written against C++11 atomics (single-word CAS,
FAA, marked pointers with embedded version tags).  CPython has no such
primitives; we emulate each atomic *cell* with a per-cell mutex so that every
load / store / CAS / FAA is individually linearizable.  Threads still
interleave arbitrarily *between* atomic operations (the GIL preempts every few
bytecodes), so the interleaving-sensitive logic of the algorithms is genuinely
exercised.  What does NOT transfer from the paper is the C++ memory-ordering
reasoning (acquire/release placement); under the emulation every atomic op is
sequentially consistent, which is strictly stronger and therefore safe.

Marked pointers reproduce the paper's layout faithfully:

  [ version tag : 17 bits | delete mark : 1 bit ]  alongside the referent

The tag is incremented (mod 2**17) on every successful mutation of the cell,
exactly like the paper's ABA protection, including the (astronomically
unlikely) wrap-around blind spot the paper describes.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

TAG_BITS = 17
TAG_MASK = (1 << TAG_BITS) - 1

# Pointer mark bits (least-significant bits "borrowed" from the pointer).
DELETE_MARK = 1


class MarkedValue:
    """An immutable (referent, mark, tag) triple — the value of a marked ptr.

    Equality is *identity* on the referent plus equality of mark and tag,
    mirroring a word-compare of a packed C++ pointer.
    """

    __slots__ = ("obj", "mark", "tag")

    def __init__(self, obj: Any, mark: int = 0, tag: int = 0) -> None:
        object.__setattr__(self, "obj", obj)
        object.__setattr__(self, "mark", mark & DELETE_MARK)
        object.__setattr__(self, "tag", tag & TAG_MASK)

    def __setattr__(self, *a):  # pragma: no cover - immutability guard
        raise AttributeError("MarkedValue is immutable")

    # -- paper interface -------------------------------------------------
    def get(self) -> Any:
        """The raw referent (without mark bits)."""
        return self.obj

    def with_mark(self, mark: int = DELETE_MARK) -> "MarkedValue":
        return MarkedValue(self.obj, mark, self.tag)

    def clear_mark(self) -> "MarkedValue":
        return MarkedValue(self.obj, 0, self.tag)

    # -- equality = word comparison --------------------------------------
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MarkedValue):
            return NotImplemented
        return (
            self.obj is other.obj
            and self.mark == other.mark
            and self.tag == other.tag
        )

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash((id(self.obj), self.mark, self.tag))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        name = getattr(self.obj, "name", None) or (
            "null" if self.obj is None else type(self.obj).__name__
        )
        return f"MarkedValue({name}, mark={self.mark}, tag={self.tag})"


NULL = MarkedValue(None, 0, 0)


class AtomicMarkedRef:
    """Atomic cell holding a :class:`MarkedValue` with tag-incrementing CAS.

    Every successful mutation bumps the version tag mod 2**17, reproducing
    the paper's ABA defence.  ``compare_exchange`` compares the full
    (referent, mark, tag) word.
    """

    __slots__ = ("_lock", "_value")

    def __init__(self, obj: Any = None, mark: int = 0) -> None:
        self._lock = threading.Lock()
        self._value = MarkedValue(obj, mark, 0)

    def load(self) -> MarkedValue:
        with self._lock:
            return self._value

    def store(self, obj: Any, mark: int = 0) -> None:
        """Unconditional store; bumps the tag like any other mutation."""
        with self._lock:
            self._value = MarkedValue(obj, mark, self._value.tag + 1)

    def compare_exchange(
        self, expected: MarkedValue, obj: Any, mark: int = 0
    ) -> bool:
        """CAS: install (obj, mark, expected.tag + 1) iff cell == expected."""
        with self._lock:
            if self._value == expected:
                self._value = MarkedValue(obj, mark, expected.tag + 1)
                return True
            return False

    # Convenience used by the Stamp Pool -----------------------------------
    def set_mark(self) -> MarkedValue:
        """Atomically set the delete mark; return the *post-mark* value.

        Corresponds to ``set_mark_flag`` in the paper's ``remove`` (Listing 5).
        Idempotent: if the mark is already set, returns the current value.
        """
        with self._lock:
            v = self._value
            if not (v.mark & DELETE_MARK):
                v = MarkedValue(v.obj, v.mark | DELETE_MARK, v.tag + 1)
                self._value = v
            return v


class AtomicInt:
    """Atomic integer with load/store/FAA/CAS (for stamps and epochs)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0) -> None:
        self._lock = threading.Lock()
        self._value = value

    def load(self) -> int:
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value

    def fetch_add(self, delta: int) -> int:
        """Returns the value *before* the addition (C++ semantics)."""
        with self._lock:
            old = self._value
            self._value = old + delta
            return old

    def compare_exchange(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._value == expected:
                self._value = desired
                return True
            return False

    def max_update(self, candidate: int) -> int:
        """Monotonic max (CAS-loop collapsed under the cell lock)."""
        with self._lock:
            if candidate > self._value:
                self._value = candidate
            return self._value


class AtomicRef:
    """Atomic reference cell (plain, unmarked) with CAS.

    Used for data-structure links where no mark bits are needed (e.g. the
    Michael&Scott queue tail) and for scheme-internal pointers.
    """

    __slots__ = ("_lock", "_value")

    def __init__(self, value: Any = None) -> None:
        self._lock = threading.Lock()
        self._value = value

    def load(self) -> Any:
        with self._lock:
            return self._value

    def store(self, value: Any) -> None:
        with self._lock:
            self._value = value

    def compare_exchange(self, expected: Any, desired: Any) -> bool:
        """Identity-compare CAS (is-comparison, like a pointer compare)."""
        with self._lock:
            if self._value is expected:
                self._value = desired
                return True
            return False

    def exchange(self, value: Any) -> Any:
        with self._lock:
            old = self._value
            self._value = value
            return old
