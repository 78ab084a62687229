"""Widget dispatch (the port's copy of stract_tpu/widgets/manager.py; role of reference searcher/api/widget.rs:51 WidgetManager)."""

from __future__ import annotations

from .calculator import Calculator
from .thesaurus import Thesaurus


class WidgetManager:
    def __init__(self, thesaurus: Thesaurus | None = None):
        self.calculator = Calculator()
        self.thesaurus = thesaurus or Thesaurus()

    def widget(self, query: str) -> dict | None:
        w = self.calculator.try_calculate(query)
        if w is not None:
            return w
        return self.thesaurus.try_define(query)
