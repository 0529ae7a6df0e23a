"""Relation datasets for ranking (port of
``analytics_zoo_tpu/feature/text/relations.py``): the ``Relation(id1,
id2, label)`` record, CSV and parquet readers, the (positive, negative)
pairs of the ``rank_hinge`` layout, drawn from
``np.random.RandomState(seed)`` as the reference draws them, and the
per-query groups of the evaluation layout."""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Relation:
    id1: str
    id2: str
    label: int


class Relations:
    @staticmethod
    def read(path: str) -> "list[Relation]":
        """CSV with columns id1,id2,label (reference `Relations.read`)."""
        out = []
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            rows = list(reader)
        start = 0
        if rows and rows[0][:2] == ["id1", "id2"]:
            start = 1
        for row in rows[start:]:
            if len(row) < 3:
                continue
            out.append(Relation(row[0], row[1], int(row[2])))
        return out

    @staticmethod
    def read_parquet(path: str) -> "list[Relation]":
        """Columns ``id1, id2, label`` of a parquet file (pandas,
        imported here)."""
        import pandas as pd
        df = pd.read_parquet(path)
        return [Relation(str(r.id1), str(r.id2), int(r.label))
                for r in df.itertuples()]

    @staticmethod
    def generate_relation_pairs(relations: "list[Relation]",
                                seed: int = 0
                                ) -> "list[tuple[Relation, Relation]]":
        """(positive, negative) pairs per id1 — the training layout for
        `rank_hinge` loss (reference `TextSet.fromRelationPairs`)."""
        rng = np.random.RandomState(seed)
        by_q: "dict[str, dict[int, list[Relation]]]" = {}
        for r in relations:
            by_q.setdefault(r.id1, {}).setdefault(
                1 if r.label > 0 else 0, []).append(r)
        pairs = []
        for q, groups in by_q.items():
            pos, neg = groups.get(1, []), groups.get(0, [])
            if not pos or not neg:
                continue
            for p in pos:
                pairs.append((p, neg[rng.randint(len(neg))]))
        return pairs

    @staticmethod
    def group_by_query(relations: "list[Relation]"
                       ) -> "dict[str, list[Relation]]":
        """id1 → candidate list (reference `TextSet.fromRelationLists`
        evaluation layout for NDCG/MAP)."""
        groups: "dict[str, list[Relation]]" = {}
        for r in relations:
            groups.setdefault(r.id1, []).append(r)
        return groups
