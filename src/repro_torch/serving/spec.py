"""SpecPlane: model-free speculative decoding — drafting side + controller.

Every decode step on the paged plane emits exactly one token per slot; this
module supplies the DRAFTS that let the batched verify step
(``serving/decode.py::DecodeEngine._verify_impl``, the spec-verify kernel on
full-attention layers) emit several. Drafting is
draft-model-free (prompt-lookup speculation): candidate continuations come
from token statistics the serving system already holds —

  1. ``PromptLookupSource`` — each request's OWN history (prompt + emitted
     tokens), via per-request n-gram maps: the most recent PREVIOUS
     occurrence of the current tail n-gram proposes the tokens that
     followed it. This is the workhorse on repetitive/structured output
     (code, JSON, extraction, self-quoting chat).
  2. ``RadixDraftSource`` — the proxy's ``RadixTree`` of served prompts:
     when the live history is a strict prefix of a longer stored prompt
     (multi-turn prefix growth), the tree's stored continuation is the
     draft. Read-only: drafting never perturbs the tree's LRU order.
  3. ``SuffixTableSource`` — a global LRU n-gram → continuation table fed
     by FINISHED requests, giving cross-request speculation on shared
     phrasing.

Every source reads only tokens (admission, accepted tokens), finished or
preempted requests and the proxy's tree of served prompts, nothing of the
device, so over several ranks, which admit, emit, release and dispatch
alike, every rank's controller drafts the same tokens.

Correctness never depends on draft quality: the verify step accepts exactly
the longest prefix matching its own greedy argmax and re-derives every
emitted token from its own logits, so the emitted stream is bit-identical
to non-speculative greedy decode under ANY draft source (including an
adversarial one) — bad drafts only waste verify FLOPs. The controller
therefore restricts WHERE speculation runs, not what it may propose:

  - greedy slots only (temperature > 0 folds a sampler draw per position;
    the verify step masks drafts for sampled slots on the device, the
    controller just skips the wasted drafting work);
  - refuses stacks with SSM layers (no multi-token rollback path for
    recurrent state) and engines running OmniAttn online top-k selection
    (block selection is query-dependent, so verify-position selections
    would diverge from the baseline's per-step selections and break the
    bit-identity contract);
  - caps the draft length so the verify window fits the smallest ring
    (k + 1 ≤ min recent — the same bound chunked prefill obeys, and what
    keeps in-window ring slots distinct for the commit scatter).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs (ServerConfig.spec / DecodeEngine.spec)."""
    k: int = 4                  # max draft tokens per slot per verify step
    ngram: int = 3              # tail n-gram length for lookup matching
    suffix_entries: int = 512   # global suffix-table LRU capacity (entries)
    suffix_len: int = 8         # continuation tokens stored per suffix entry
    use_radix: bool = True      # consult the proxy RadixTree
    use_suffix: bool = True     # maintain the cross-request suffix table


# ======================================================================
class DraftSource:
    """One way of proposing continuations. All hooks are host-side and
    per-engine-thread; `draft` must be deterministic given the same call
    history (the bench's exact-vs-spec runs rely on reproducible drafting
    even though correctness does not)."""

    name = "base"

    def on_admit(self, rid, history: list) -> None:
        """`rid` entered a decode slot with `history` (prompt + first
        sampled token; a preemption resume sees prompt + resume token)."""

    def on_tokens(self, rid, history: list, n_new: int) -> None:
        """`history` grew by its last `n_new` entries (accepted tokens)."""

    def on_release(self, rid, history: list) -> None:
        """`rid` left its slot (finish / preempt / fault recovery)."""

    def draft(self, rid, history: list, k: int) -> list:
        return []


class PromptLookupSource(DraftSource):
    """Per-request prompt-lookup n-gram maps (two-level: current + previous
    occurrence). Registering token i stores, for every gram length 1..n,
    gram(...,i) → (i+1, previous start): the continuation start of the most
    recent occurrence, with one level of lookback so the just-registered
    tail gram (whose continuation is the unknown future) still exposes its
    previous occurrence. Drafting tries the longest gram first."""

    name = "prompt_lookup"

    def __init__(self, ngram: int):
        self.ngram = max(ngram, 1)
        self.maps: dict = {}            # rid → {gram tuple: (last, prev)}

    def _register(self, m: dict, h: list, i: int) -> None:
        for n in range(1, self.ngram + 1):
            if i + 1 < n:
                break
            g = tuple(h[i + 1 - n:i + 1])
            old = m.get(g)
            m[g] = (i + 1, old[0] if old is not None else None)

    def on_admit(self, rid, history):
        m = self.maps[rid] = {}
        for i in range(len(history)):
            self._register(m, history, i)

    def on_tokens(self, rid, history, n_new):
        m = self.maps.get(rid)
        if m is None:
            return
        for i in range(len(history) - n_new, len(history)):
            self._register(m, history, i)

    def on_release(self, rid, history):
        self.maps.pop(rid, None)

    def draft(self, rid, h, k):
        m = self.maps.get(rid)
        if not m:
            return []
        M = len(h)
        work = list(h)
        out: list = []
        # extend one token at a time THROUGH the map (longest gram first)
        # instead of copying a single history window: near the history tail
        # a window draft clips at the boundary, but on cyclic/repetitive
        # output each drafted token's own tail gram is back in the map, so
        # the walk keeps proposing right up to the k cap
        while len(out) < k:
            nxt = None
            for n in range(self.ngram, 0, -1):
                if len(work) < n:
                    continue
                ent = m.get(tuple(work[-n:]))
                if ent is None:
                    continue
                # a gram ending at the history tail was registered with
                # start M (its continuation is the unknown future) — use
                # its PREVIOUS occurrence instead
                p = ent[1] if ent[0] >= M else ent[0]
                if p is not None and p < M:
                    nxt = h[p]
                    break
            if nxt is None:
                break
            out.append(nxt)
            work.append(nxt)
        return out


class RadixDraftSource(DraftSource):
    """Prompt-lookup against the proxy's RadixTree of served prompts —
    read-only (`RadixTree.continuation` touches no LRU state, so spec
    on/off cannot change which prefixes stay cached)."""

    name = "radix"

    def __init__(self, tree):
        self.tree = tree

    def draft(self, rid, h, k):
        return list(self.tree.continuation(h, k))


class SuffixTableSource(DraftSource):
    """Global LRU n-gram → continuation table fed by finished requests.
    Capacity is an ENTRY count; insertion and lookup both refresh LRU
    order, eviction pops the stalest entry."""

    name = "suffix"

    def __init__(self, ngram: int, max_entries: int, cont_len: int):
        self.ngram = max(ngram, 1)
        self.max_entries = max_entries
        self.cont_len = max(cont_len, 1)
        self.table: OrderedDict = OrderedDict()

    def on_release(self, rid, h):
        n = self.ngram
        for i in range(n - 1, len(h) - 1):
            g = tuple(h[i + 1 - n:i + 1])
            self.table[g] = tuple(h[i + 1:i + 1 + self.cont_len])
            self.table.move_to_end(g)
        while len(self.table) > self.max_entries:
            self.table.popitem(last=False)

    def draft(self, rid, h, k):
        if len(h) < self.ngram:
            return []
        g = tuple(h[-self.ngram:])
        hit = self.table.get(g)
        if not hit:
            return []
        self.table.move_to_end(g)
        return list(hit[:k])


# ======================================================================
class SpecController:
    """Per-engine owner of drafting state, speculation policy, and the
    spec stats contract (the [4] device accumulator drained by
    ``DecodeEngine.take_spec_stats``)."""

    def __init__(self, cfg: SpecConfig, k: int, sources: list):
        self.cfg = cfg
        self.k = k                      # effective draft cap (ring-bounded)
        self.sources = sources
        self.hist: dict = {}            # rid → [int] prompt + emitted tokens

    # ---- construction -------------------------------------------------
    @staticmethod
    def from_model(lm, cfg: Optional[SpecConfig], *, sparsity=None,
                   radix=None) -> Optional["SpecController"]:
        """→ a controller when `cfg` enables speculation (k > 0), else
        None. Raises when the engine cannot honor the bit-identity
        contract: SSM layers (no multi-token rollback for recurrent state)
        or an active OmniAttn top-k SparsityController (query-dependent
        block selection diverges across verify positions). The draft cap is
        clamped to the smallest ring window (k + 1 ≤ recent) and silently
        degrades to OFF when even one draft cannot fit."""
        if cfg is None or cfg.k <= 0:
            return None
        if sparsity is not None:
            raise ValueError(
                "speculative decoding cannot compose with OmniAttn online "
                "top-k selection: block selection is query-dependent, so "
                "verify-window selections would diverge from the baseline's "
                "per-step selections and break greedy bit-identity")
        if any(s.kind != "attn" for s in lm.plan.all_specs()):
            raise ValueError(
                "speculative decoding requires an attention-only stack: "
                "SSM layers have no multi-token rollback path")
        supported, limit = lm.chunked_prefill_support
        if not supported:
            raise ValueError("stack does not support multi-position verify")
        k = min(cfg.k, max(limit - 1, 0))
        if k <= 0:
            return None             # no ring can fit a window: spec off
        sources: list = [PromptLookupSource(cfg.ngram)]
        if cfg.use_radix and radix is not None:
            sources.append(RadixDraftSource(radix))
        if cfg.use_suffix:
            sources.append(SuffixTableSource(cfg.ngram, cfg.suffix_entries,
                                             cfg.suffix_len))
        return SpecController(cfg, k, sources)

    # ---- slot lifecycle ----------------------------------------------
    def on_admit(self, rid, prompt, tok) -> None:
        h = [int(t) for t in (prompt or ())]
        if tok is not None:
            h.append(int(tok))
        self.hist[rid] = h
        for s in self.sources:
            s.on_admit(rid, h)

    def on_tokens(self, rid, toks) -> None:
        h = self.hist.get(rid)
        if h is None:
            return
        h.extend(int(t) for t in toks)
        for s in self.sources:
            s.on_tokens(rid, h, len(toks))

    def on_release(self, rid) -> None:
        h = self.hist.pop(rid, None)
        if h is None:
            return
        for s in self.sources:
            s.on_release(rid, h)

    # ---- drafting -----------------------------------------------------
    def draft(self, rid) -> list:
        """Up to `self.k` candidate continuations for `rid`, from the first
        source with an opinion (own-history lookup, then radix, then the
        cross-request suffix table). [] → this slot rides the window as a
        plain single-token row."""
        h = self.hist.get(rid)
        if not h:
            return []
        for s in self.sources:
            d = s.draft(rid, h, self.k)
            if d:
                return [int(t) for t in d[:self.k]]
        return []

    # ---- stats contract ----------------------------------------------
    @staticmethod
    def stats_keys() -> dict:
        """Engine-stats schema (benches reset these between warmup and
        measurement). Device-side [4] accumulator order:
        [drafted, accepted, emitted, verify steps]."""
        return {"spec_drafted": 0, "spec_accepted": 0,
                "spec_emitted": 0, "spec_verifies": 0}

    @staticmethod
    def note(stats: dict, vec) -> None:
        stats["spec_drafted"] += int(round(float(vec[0])))
        stats["spec_accepted"] += int(round(float(vec[1])))
        stats["spec_emitted"] += int(round(float(vec[2])))
        stats["spec_verifies"] += int(round(float(vec[3])))

    @staticmethod
    def draft_acceptance(stats: dict) -> float:
        """Fraction of drafted tokens the verify accepted (NaN: no drafts)."""
        d = stats.get("spec_drafted", 0)
        return stats.get("spec_accepted", 0) / d if d else float("nan")

    @staticmethod
    def tokens_per_verify(stats: dict) -> float:
        """Mean tokens emitted per verify step (NaN: no verifies)."""
        n = stats.get("spec_verifies", 0)
        return stats.get("spec_emitted", 0) / n if n else float("nan")
