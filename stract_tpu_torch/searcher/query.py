"""SearchQuery — the user-facing query struct (role of reference
searcher/mod.rs:75 SearchQuery)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SearchQuery:
    query: str
    page: int = 0
    num_results: int = 20
    selected_region: int = 0
    optic: str | None = None                  # optic source text
    host_rankings: object = None
    return_ranking_signals: bool = False
    safe_search: bool = False
    count_results_exact: bool = False
    signal_coefficients: dict = field(default_factory=dict)

    def offset(self) -> int:
        return self.page * self.num_results

    def to_json(self) -> dict:
        return {
            "query": self.query,
            "page": self.page,
            "num_results": self.num_results,
            "selected_region": self.selected_region,
            "optic": self.optic,
            "return_ranking_signals": self.return_ranking_signals,
            "safe_search": self.safe_search,
            "count_results_exact": self.count_results_exact,
            "signal_coefficients": self.signal_coefficients,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SearchQuery":
        """Accepts both snake_case (internal RPC) and camelCase (public HTTP
        API, matching the reference's serde rename_all = camelCase)."""
        import re

        norm = {re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower(): v for k, v in d.items()}
        return cls(**{k: v for k, v in norm.items() if k in cls.__dataclass_fields__})
