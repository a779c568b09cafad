"""Speculative decoding: draft k tokens host-side, verify in one forward.

A copy of the JAX package's ``serve/spec.py`` (framework-neutral numpy,
copied because the port never imports the JAX package); the acceptance
rules are pure functions of the request's numpy Generator, so the port's
draws equal the reference's.

The decode loop's ceiling is one compiled program dispatch per emitted
token. Speculative decoding (Leviathan et al. 2023; Chen et al. 2023)
raises it: a cheap *drafter* proposes up to ``k`` continuation tokens,
the model scores all ``k+1`` positions in ONE ``verify_step`` forward,
and the engine accepts the agreeing prefix plus one bonus token — so a
step emits between 1 and ``k+1`` tokens with zero quality change.

This module is the host half of the subsystem:

- :class:`DraftProposer` — the drafter contract. The default
  :class:`NgramProposer` is *self-speculative* (prompt-lookup): it scans
  the request's own prompt + emitted tokens for a previous occurrence of
  the current suffix n-gram and proposes what followed it. No second
  model, no new weights. A small-draft-model proposer is the documented
  stretch: implement ``propose`` over a distilled model behind this same
  interface and pass it via ``SpecConfig(drafter=...)``.
- :func:`accept_greedy` / :func:`accept_sampled` — the acceptance rules.
  Greedy acceptance is exactly the one-token stream (each emitted token
  is the argmax the sequential decode would have produced — greedy
  speculated streams equal non-speculated ones wherever the verify rows
  equal the decode step's, which the port pins on the CPU and measures
  on the card).
  Sampled acceptance is the standard rejection rule specialised to a
  point-mass draft distribution: accept draft token ``d`` with
  probability ``p_target(d)``; on rejection sample from the residual
  (``p_target`` with ``d`` zeroed, renormalised). The marginal over
  emitted tokens is exactly ``p_target`` — speculation never changes
  the sampling distribution (a chi-square test pins it).
  All randomness comes from the per-request seeded Generator, so seeded
  speculated streams stay run-to-run deterministic.
- :class:`SpecConfig` — the engine knob: ``GenerationEngine(spec=
  SpecConfig(k=4))``. JSON round-trips via ``to_spec``/``from_spec``.

The model half — ``verify_step`` / ``paged_verify_step`` — lives in
:mod:`horovod_tpu_torch.parallel.transformer` / ``.kv_blocks``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

__all__ = ["DraftProposer", "NgramProposer", "SpecConfig",
           "accept_greedy", "accept_sampled"]

_EMPTY = np.empty((0,), np.int64)


@runtime_checkable
class DraftProposer(Protocol):
    """Host-side drafter: propose up to ``k`` continuation tokens.

    ``context`` is the request's full token history (prompt + every
    emitted token, most recent last); the proposal continues it.
    Returning fewer than ``k`` tokens (or none) is always legal — the
    engine pads the verify batch and a slot with no proposal simply
    takes its normal one-token step, so a drafter can never stall a
    stream. Proposals are hints, not promises: a wrong draft costs only
    the wasted verify rows.
    """

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ...


@dataclasses.dataclass
class NgramProposer:
    """Prompt-lookup / n-gram self-speculative drafter.

    Finds the most recent earlier occurrence of the context's trailing
    n-gram (trying window sizes ``max_ngram`` down to ``min_ngram``) and
    proposes the tokens that followed it. Pure host-side numpy over a
    few hundred tokens — effectively free next to a forward pass. It
    shines exactly where decoding is slowest to watch: repetitive
    continuations (code, templated text, self-repeating outputs), where
    the acceptance rate approaches 1 and a step emits ``k+1`` tokens.
    """
    max_ngram: int = 3
    min_ngram: int = 1

    def __post_init__(self):
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min={self.min_ngram} max={self.max_ngram}")

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context).ravel()
        n = int(ctx.size)
        if n < 2 or k <= 0:
            return _EMPTY
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pat = ctx[n - g:]
            # Candidate starts strictly before the suffix itself; walk
            # right-to-left so the MOST RECENT occurrence wins (recent
            # repetition is the best predictor of the next tokens).
            cand = np.flatnonzero(ctx[:n - g] == pat[0])
            for i in cand[::-1]:
                if np.array_equal(ctx[i:i + g], pat):
                    j = int(i) + g
                    return ctx[j:min(j + k, n)].astype(np.int64)
        return _EMPTY


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knob for :class:`~.generate.GenerationEngine`.

    Args:
      k: max draft tokens per step; the verify forward scores ``k+1``
        positions per slot.
      max_ngram/min_ngram: the default :class:`NgramProposer`'s window.
      drafter: override the drafter entirely (any
        :class:`DraftProposer`). Custom drafters are engine-local and
        not JSON-serialisable into a subprocess replica spec.
    """
    k: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    drafter: Optional[DraftProposer] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min={self.min_ngram} max={self.max_ngram}")

    def make_drafter(self) -> DraftProposer:
        if self.drafter is not None:
            return self.drafter
        return NgramProposer(max_ngram=self.max_ngram,
                             min_ngram=self.min_ngram)

    def to_spec(self) -> dict:
        """JSON form for the subprocess replica spec (``"spec"`` entry)."""
        if self.drafter is not None:
            raise ValueError(
                "custom drafters are not serialisable into a subprocess "
                "replica spec; use the built-in n-gram drafter knobs")
        return {"k": self.k, "max_ngram": self.max_ngram,
                "min_ngram": self.min_ngram}

    @staticmethod
    def from_spec(d: dict) -> "SpecConfig":
        return SpecConfig(k=int(d.get("k", 4)),
                          max_ngram=int(d.get("max_ngram", 3)),
                          min_ngram=int(d.get("min_ngram", 1)))


def accept_greedy(rows: np.ndarray,
                  draft: Sequence[int]) -> Tuple[List[int], int]:
    """Greedy acceptance over verify logits.

    ``rows`` is ``[W, vocab]`` (row ``j`` = next-token logits after
    consuming the last token plus ``draft[:j]``); ``draft`` holds up to
    ``W - 1`` proposed tokens. Emits the argmax chain: row ``j``'s
    argmax, continuing while it equals ``draft[j]`` (so the next row's
    context is real), plus one bonus token from the row after the last
    match. Exactly the tokens sequential greedy decode would emit —
    never more rows than the context justifies.

    Returns ``(tokens, hits)`` where ``hits`` counts draft-accepted
    tokens (the accepted prefix; ``len(tokens) == hits + 1``).
    """
    out: List[int] = []
    hits = 0
    for j, d in enumerate(draft):
        e = int(np.argmax(rows[j]))
        out.append(e)
        if e != int(d):
            return out, hits
        hits += 1
    out.append(int(np.argmax(rows[len(draft)])))
    return out, hits


def accept_sampled(rows: np.ndarray, draft: Sequence[int], probs_fn,
                   rng: np.random.Generator) -> Tuple[List[int], int]:
    """Rejection-rule acceptance for seeded sampling (point-mass draft).

    ``probs_fn(logits_row) -> [vocab] float64 probs`` is the request's
    temperature/top-k transform — the TARGET distribution sequential
    decode would sample from. Per draft token ``d``: accept with
    probability ``p(d)`` (one uniform draw); on rejection emit a draw
    from the residual ``p`` with ``d`` zeroed, renormalised, and stop.
    After a fully-accepted draft, emit one bonus draw from the last
    row. Marginally each emitted token ~ ``p`` exactly (chi-square
    pinned), and the draw sequence is a pure function of the seeded
    ``rng`` — deterministic re-runs and bit-identical failover replay.

    Returns ``(tokens, hits)`` as in :func:`accept_greedy`.
    """
    out: List[int] = []
    hits = 0
    for j, d in enumerate(draft):
        d = int(d)
        p = probs_fn(rows[j])
        if rng.random() < p[d]:
            out.append(d)
            hits += 1
            continue
        q = p.copy()
        q[d] = 0.0
        tot = q.sum()
        if tot <= 0.0:
            # Target IS the point mass on d; the accept draw can only
            # have failed on an fp edge — the draft token is the whole
            # distribution, emit it.
            out.append(d)
            hits += 1
            continue
        out.append(int(rng.choice(q.size, p=q / tot)))
        return out, hits
    p = probs_fn(rows[len(draft)])
    out.append(int(rng.choice(p.size, p=p)))
    return out, hits
