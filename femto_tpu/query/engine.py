"""Query execution: parsed AST -> device-batched index operations.

The high-level analog of the reference's results-query layer
(string_results_query server.c:4927, regexp_results_query :5082,
generic_boolean_query server.h:591-598): string terms run one batched
backward search; regexp/approx terms run the frontier engine; Boolean
nodes combine Results sets.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..fmindex import FMIndex
from ..search import count_ranges, locate_range, offsets_to_docs, range_docs
from .ast import (
    QAnd,
    QNode,
    QNot,
    QOr,
    QTerm,
    QThen,
    QWithin,
    as_literal,
)
from .nfa import compile_nfa
from .parser import parse_query
from .regexp import RegexpMatch, match_rows, run_regexp
from .results import (
    Results,
    ResultType,
    intersect,
    subtract,
    then_within,
    union,
)


def term_ranges(index: FMIndex, term: QTerm,
                max_results: int = 10000,
                device_frontier: bool = True) -> List[Tuple[int, int, int]]:
    """Row ranges (first, last, cost) matching a term.

    The device lockstep frontier (regexp_device.py) runs the whole search
    in one dispatch and falls back to the host per-layer engine on capacity overflow; pass
    device_frontier=False to force the host engine (e.g. to avoid the
    one-time per-NFA-shape compile)."""
    from .planning import matches_empty, streamline

    regexp = streamline(term.regexp)
    if matches_empty(regexp):
        # empty string matches every row (query_planning semantics)
        return [(index.meta.row0, index.meta.n_rows, 0)]
    lit = as_literal(regexp)
    if lit is not None and term.approx.cost_bound <= 1:
        first, last = count_ranges(index, [lit])
        f, l = int(first[0]), int(last[0])
        return [(f, l, 0)] if l > f else []
    nfa = compile_nfa(regexp)
    # paged indexes (paged.PagedIndex) fault per layer, which only the
    # host engine's layer-at-a-time dispatch structure supports
    if device_frontier and not hasattr(index, "_ensure_rows"):
        from .regexp_device import run_regexp_device

        try:
            matches = run_regexp_device(index, nfa, term.approx)
            return [(m.first, m.last, m.cost) for m in matches]
        except RuntimeError:
            pass  # capacity overflow: fall back to the host engine
    matches = run_regexp(index, nfa, term.approx, max_results=max_results)
    return [(m.first, m.last, m.cost) for m in matches]


def apply_icase(node: QNode) -> QNode:
    """Case-fold every term's regexp in a Boolean tree (--icase)."""
    from .planning import fold_case

    if isinstance(node, QTerm):
        return QTerm(regexp=fold_case(node.regexp), approx=node.approx)
    node2 = type(node)(**{**node.__dict__})
    node2.left = apply_icase(node.left)
    node2.right = apply_icase(node.right)
    return node2


def find_strings(index: FMIndex, query: str,
                 max_results: int = 10000,
                 icase: bool = False) -> List[RegexpMatch]:
    """femto.h find_strings: matching strings with ranges and costs."""
    from .planning import streamline

    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    if not isinstance(node, QTerm):
        raise ValueError("find_strings takes a single term, not a boolean")
    regexp = streamline(node.regexp)
    lit = as_literal(regexp)
    if lit is not None and node.approx.cost_bound <= 1:
        first, last = count_ranges(index, [lit])
        f, l = int(first[0]), int(last[0])
        return [RegexpMatch(f, l, 0, lit)] if l > f else []
    nfa = compile_nfa(regexp)
    if not hasattr(index, "_ensure_rows"):  # device frontier, unless paged
        try:
            from .regexp_device import run_regexp_device

            return run_regexp_device(index, nfa, node.approx,
                                     with_strings=True)
        except RuntimeError:
            pass
    return run_regexp(index, nfa, node.approx, max_results=max_results)


# Streaming locate window: offset-bearing terms with no cap walk their row
# ranges in windows of this many rows (bounds device memory per dispatch),
# accumulating the FULL doc/offset set — the reference's semantics
# (full result sets, results.h:115-121) with bounded peak footprint.
LOCATE_WINDOW = 1 << 20


def term_results(index: FMIndex, term: QTerm, need_offsets: bool,
                 max_matches: Optional[int] = None) -> Results:
    """Materialize one term's Results.  max_matches=None means FULL
    evaluation: every matching row is located (in LOCATE_WINDOW-row
    streaming windows) and the result is never truncated."""
    ranges = term_ranges(index, term)
    # union of match row intervals (distinct matching positions)
    iv = match_rows([RegexpMatch(f, l, c, b"") for f, l, c in ranges])
    total = sum(l - f for f, l in iv)
    if not need_offsets and index.chunk_docs_np is not None:
        # docs-only fast path: chunk doc-lists serve whole segments
        docs = [range_docs(index, f, l) for f, l in iv]
        res = Results.from_docs(
            np.concatenate(docs) if docs else np.zeros(0, np.int64)
        )
        res.count = total
        return res
    docs_all, offs_all = [], []
    budget = max_matches
    for f, l in iv:
        take = l - f if budget is None else min(l - f, budget)
        if take <= 0:
            break
        for wf in range(f, f + take, LOCATE_WINDOW):
            offs = locate_range(index, wf, min(wf + LOCATE_WINDOW, f + take))
            d, o = offsets_to_docs(index, offs)
            docs_all.append(d)
            offs_all.append(o)
        if budget is not None:
            budget -= take
    if docs_all:
        docs = np.concatenate(docs_all)
        offs = np.concatenate(offs_all)
    else:
        docs = np.zeros(0, np.int64)
        offs = np.zeros(0, np.int64)
    res = Results.from_doc_offsets(docs, offs)
    res.count = total
    # fewer rows materialized than matched: the doc/offset lists are
    # incomplete (reference semantics are full result sets,
    # results.h:115-121 — truncation must be SURFACED, never silent)
    res.truncated = max_matches is not None and total > max_matches
    return res


class TruncationWarning(UserWarning):
    """A Boolean term exceeded the materialization cap: the query's
    document set may be incomplete."""


def _warn_truncated(res: Results, query: str) -> None:
    if res.truncated:
        warnings.warn(
            f"query {query!r}: a term exceeded the Boolean materialization "
            f"cap ({BOOLEAN_TERM_CAP} rows); results may be incomplete",
            TruncationWarning, stacklevel=3,
        )


# Per-term work bound applied ONLY when the caller opts out of full
# evaluation (full_eval=False): Boolean operands are then capped at this
# many materialized rows and truncation is surfaced.  With the default
# full evaluation, operands stream ALL their rows (LOCATE_WINDOW windows)
# and results are exact — the reference's semantics (results.h:115-121).
BOOLEAN_TERM_CAP = 1_000_000


def execute(index: FMIndex, node: QNode, need_offsets: bool = True,
            max_matches: Optional[int] = None,
            term_cap: Optional[int] = None,
            _under_boolean: bool = False) -> Results:
    """Evaluate a Boolean/regexp query tree to a Results set.

    term_cap=None (the default) evaluates Boolean operands in FULL;
    a positive term_cap bounds per-operand materialization (the caller
    explicitly traded completeness for work) and truncation is flagged."""
    if isinstance(node, QTerm):
        cap = term_cap if _under_boolean else max_matches
        return term_results(index, node, need_offsets, cap)
    # THEN/WITHIN compare offsets, so operands must carry them even when
    # the caller only wants documents.
    child_offsets = need_offsets or isinstance(node, (QThen, QWithin))
    a = execute(index, node.left, child_offsets, max_matches, term_cap,
                _under_boolean=True)
    b = execute(index, node.right, child_offsets, max_matches, term_cap,
                _under_boolean=True)
    if isinstance(node, QAnd):
        return intersect(a, b)
    if isinstance(node, QOr):
        return union(a, b)
    if isinstance(node, QNot):
        return subtract(a, b)
    if isinstance(node, QThen):
        return then_within(a, b, node.distance, ordered=True)
    if isinstance(node, QWithin):
        return then_within(a, b, node.distance, ordered=False)
    raise TypeError(node)


def count_query(index: FMIndex, query: str, icase: bool = False) -> int:
    """Total matching positions for a (term) query; for Boolean queries,
    the number of matching documents."""
    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    if isinstance(node, QTerm):
        iv = match_rows(
            [RegexpMatch(f, l, c, b"") for f, l, c in term_ranges(index, node)]
        )
        return sum(l - f for f, l in iv)
    # Boolean count only reads the doc set: route operands through the
    # uncapped chunk doc-list path (THEN/WITHIN pull offsets themselves).
    res = execute(index, node, need_offsets=False)
    _warn_truncated(res, query)
    return len(res.doc_set())


def docs_query_ex(index: FMIndex, query: str,
                  max_matches: Optional[int] = None,
                  with_offsets: bool = True,
                  icase: bool = False,
                  full_eval: bool = True):
    """find_docs returning (rows, truncated): truncated=True means a
    Boolean term hit the materialization cap and the doc set may be
    incomplete (a top-level term limited by the CALLER's max_matches is
    not flagged — that truncation was requested).  full_eval=True (the
    default) evaluates Boolean operands exactly (streamed, uncapped);
    full_eval=False bounds each operand at BOOLEAN_TERM_CAP rows."""
    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    res = execute(index, node, need_offsets=with_offsets,
                  max_matches=max_matches,
                  term_cap=None if full_eval else BOOLEAN_TERM_CAP)
    out = []
    for d in res.doc_set():
        if res.type == ResultType.DOC_OFFSETS:
            offs = res.offsets[res.docs == d].tolist()
        else:
            offs = []
        out.append((int(d), index.infos[int(d)], offs))
        if max_matches is not None and len(out) >= max_matches:
            break
    truncated = res.truncated and not isinstance(node, QTerm)
    return out, truncated


def docs_query(index: FMIndex, query: str,
               max_matches: Optional[int] = None,
               with_offsets: bool = True,
               icase: bool = False,
               full_eval: bool = True):
    """find_docs: list of (doc_id, info, offsets) matching the query.
    Boolean operands evaluate in full by default; with full_eval=False
    they are capped and a TruncationWarning fires when the cap bites."""
    out, truncated = docs_query_ex(index, query, max_matches=max_matches,
                                   with_offsets=with_offsets, icase=icase,
                                   full_eval=full_eval)
    if truncated:
        warnings.warn(
            f"query {query!r}: a term exceeded the Boolean materialization "
            f"cap ({BOOLEAN_TERM_CAP} rows); results may be incomplete",
            TruncationWarning, stacklevel=2,
        )
    return out
