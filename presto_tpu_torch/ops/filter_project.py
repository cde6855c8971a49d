"""Filter and project over Pages.

Counterpart of ``presto_tpu/ops/filter_project.py``: both run on the
K1 ``expr_eval`` kernel through ``expr/compile.py``.
"""

from __future__ import annotations

from typing import List, Sequence

from presto_tpu_torch.expr.compile import ExprCompiler, compile_filter, expr_dictionary
from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.page import Block, Page


def filter_page(page: Page, predicate: Expr) -> Page:
    """Rows where predicate is not TRUE (false or NULL) are masked out."""
    return Page(page.blocks, compile_filter(predicate, page)(page))


def project_page(page: Page, projections: Sequence[Expr]) -> Page:
    """A new Page with one block per projection expression; a bare
    column keeps its dictionary."""
    c = ExprCompiler.for_page(page)
    dicts = [b.dictionary for b in page.blocks]
    blocks: List[Block] = []
    for e in projections:
        data, valid = c.compile(e)(page)
        wants_dict = e.type.is_string or (e.type.is_array and e.type.element is not None
                                          and e.type.element.is_string)
        dictionary = expr_dictionary(e, dicts) if wants_dict else None
        blocks.append(Block(data, valid, e.type, dictionary))
    return Page(tuple(blocks), page.row_mask)
