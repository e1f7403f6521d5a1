"""Radix tree for Automatic-Prefix-Cache (APC) matching — paper §5.1.

Token-sequence radix tree with path compression, LRU eviction by token count.
One tree per prefill instance mirrors that instance's KV block cache, so
Match_P(i) (eq. 8) = longest cached prefix on instance P.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class _Node:
    edge: tuple = ()                      # compressed token run from parent
    children: dict = field(default_factory=dict)   # first-token → _Node
    last_access: float = 0.0
    n_tokens_here: int = 0                # tokens stored on this edge
    payload: object = None                # engine-side KV handle at this depth


def _common_prefix(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixTree:
    def __init__(self, capacity_tokens: int = 1 << 20):
        self.root = _Node()
        self.capacity = capacity_tokens
        self.total_tokens = 0
        self._clock = 0.0

    # ------------------------------------------------------------------
    def match(self, tokens, now: Optional[float] = None) -> int:
        """Longest cached prefix length (touches nodes for LRU)."""
        self._clock = now if now is not None else self._clock + 1e-9
        tokens = tuple(tokens)
        node, matched = self.root, 0
        while True:
            node.last_access = self._clock
            rest = tokens[matched:]
            if not rest or rest[0] not in node.children:
                return matched
            child = node.children[rest[0]]
            cp = _common_prefix(child.edge, rest)
            matched += cp
            if cp < len(child.edge):
                child.last_access = self._clock
                return matched
            node = child

    def insert(self, tokens, now: Optional[float] = None) -> int:
        """Insert a sequence; returns newly-added token count."""
        self._clock = now if now is not None else self._clock + 1e-9
        tokens = tuple(tokens)
        node, matched, added = self.root, 0, 0
        while matched < len(tokens):
            node.last_access = self._clock
            rest = tokens[matched:]
            child = node.children.get(rest[0])
            if child is None:
                new = _Node(edge=rest, last_access=self._clock,
                            n_tokens_here=len(rest))
                node.children[rest[0]] = new
                added += len(rest)
                matched = len(tokens)
                break
            cp = _common_prefix(child.edge, rest)
            if cp == len(child.edge):
                matched += cp
                node = child
                continue
            # split the edge at cp
            mid = _Node(edge=child.edge[:cp], last_access=self._clock,
                        n_tokens_here=cp)
            child.edge = child.edge[cp:]
            child.n_tokens_here = len(child.edge)
            mid.children[child.edge[0]] = child
            node.children[rest[0]] = mid
            matched += cp
            node = mid
        self.total_tokens += added
        if self.total_tokens > self.capacity:
            self._evict()
        return added

    # ------------------------------------------------------------------
    # Payload handles: the serving engine marks prefixes whose KV is
    # resident in its store, so Match_P scoring (eq. 8) and the engine agree
    # on what a prefix hit is actually worth.
    def attach(self, tokens, payload, now: Optional[float] = None) -> bool:
        """Insert `tokens` and attach a payload handle at its exact boundary;
        → True if attached. insert() splits edges at every divergence point —
        including the strict-prefix case — so the walk below consumes whole
        edges and ends on a node at exactly len(tokens), UNLESS insert's own
        LRU eviction removed part of the just-inserted path (prompt longer
        than the tree capacity): then we report False instead of attaching."""
        self.insert(tokens, now)
        tokens = tuple(tokens)
        if not tokens:
            self.root.payload = payload
            return True
        node, matched = self.root, 0
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None:
                return False          # evicted mid-path: no boundary node
            node = child
            matched += len(node.edge)
        if matched != len(tokens):
            return False
        node.payload = payload
        return True

    def detach(self, tokens, payload=None) -> bool:
        """Clear the payload handle at exactly the `tokens` boundary; when
        `payload` is given, clear only if it still matches (a superseding
        attach may have replaced it). → True if a handle was cleared.
        Dropped store entries call this so stale handles don't linger on
        the matched path until eviction."""
        tokens = tuple(tokens)
        node, matched = self.root, 0
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None:
                return False
            cp = _common_prefix(child.edge, tokens[matched:])
            if cp < len(child.edge):
                return False
            node = child
            matched += cp
        if node.payload is None or \
                (payload is not None and node.payload != payload):
            return False
        node.payload = None
        return True

    def payload_prefixes(self, tokens, now: Optional[float] = None) -> list:
        """All (depth, payload) pairs on the matched path of `tokens`,
        shallow → deep. Handles may be stale (evicted store entries):
        callers must validate against their own store."""
        self._clock = now if now is not None else self._clock + 1e-9
        tokens = tuple(tokens)
        node, matched, found = self.root, 0, []
        while True:
            node.last_access = self._clock
            rest = tokens[matched:]
            if not rest or rest[0] not in node.children:
                return found
            child = node.children[rest[0]]
            cp = _common_prefix(child.edge, rest)
            matched += cp
            if cp < len(child.edge):
                return found
            if child.payload is not None:
                found.append((matched, child.payload))
            node = child

    # ------------------------------------------------------------------
    # Speculative drafting (SpecPlane): read-only n-gram continuation.
    def continuation(self, tokens, k: int) -> list:
        """Up to `k` tokens the tree stores immediately AFTER the exact
        sequence `tokens` — the prompt-lookup draft for model-free
        speculation. READ-ONLY: no LRU touch, no clock advance, so drafting
        never perturbs eviction order (spec on/off must not change which
        prefixes stay cached). Returns [] unless the whole of `tokens`
        is present; at branch points the walk descends into the
        most-recently-accessed child (ties broken by smallest token) —
        a deterministic 'most recent continuation wins' policy."""
        if k <= 0:
            return []
        tokens = tuple(tokens)
        node, matched = self.root, 0
        out: list = []
        while matched < len(tokens):
            rest = tokens[matched:]
            child = node.children.get(rest[0])
            if child is None:
                return []
            cp = _common_prefix(child.edge, rest)
            matched += cp
            if cp < len(child.edge):
                if matched < len(tokens):
                    return []          # diverged mid-edge: no exact match
                out.extend(child.edge[cp:cp + k])   # ends inside this edge
            node = child
        while len(out) < k and node.children:
            tok = min(node.children, key=lambda t:
                      (-node.children[t].last_access, t))
            child = node.children[tok]
            take = min(k - len(out), len(child.edge))
            out.extend(child.edge[:take])
            if take < len(child.edge):
                break
            node = child
        return out

    # ------------------------------------------------------------------
    def _evict(self):
        """Evict least-recently-used leaves until under capacity."""
        while self.total_tokens > self.capacity:
            leaf, parent, key = self._lru_leaf()
            if leaf is None:
                return
            self.total_tokens -= leaf.n_tokens_here
            del parent.children[key]

    def _lru_leaf(self):
        best = (None, None, None, float("inf"))
        stack = [(self.root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            if not node.children and parent is not None:
                if node.last_access < best[3]:
                    best = (node, parent, key, node.last_access)
            for k, c in node.children.items():
                stack.append((c, node, k))
        return best[0], best[1], best[2]

    def size_tokens(self) -> int:
        return self.total_tokens
