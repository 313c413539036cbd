"""PMML export — the PyTorch port's copy of lightgbm_tpu/pmml.py (its output
is string-equal to the JAX package's for the same model text),
counterpart of pmml/pmml.py (reference): convert a saved
model (text format or in-memory Booster) to PMML XML.  Like the reference,
supports regression and binary objectives (tree ensembles with numerical /
categorical simple predicates).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

from .basic import Booster
from .utils.log import Log

_HEADER = """<?xml version="1.0" encoding="UTF-8"?>
<PMML version="4.3" xmlns="http://www.dmg.org/PMML-4_3">
\t<Header copyright="lightgbm_tpu">
\t\t<Application name="lightgbm_tpu"/>
\t</Header>
"""


def _tree_pmml(tree, feature_names: List[str], unique_id) -> List[str]:
    """One tree as a PMML TreeModel Node hierarchy (pmml.py
    print_nodes_pmml)."""
    lines: List[str] = []

    def predicate(tab, node_id, is_left, prev_idx, is_leaf):
        idx = tree.leaf_parent[node_id] if is_leaf else prev_idx
        field = feature_names[tree.split_feature[idx]]
        thr = tree.threshold[idx]
        if is_left:
            op = "equal" if tree.decision_type[prev_idx] == 1 else "lessOrEqual"
        else:
            op = "notEqual" if tree.decision_type[prev_idx] == 1 else "greaterThan"
        lines.append(
            "\t" * (tab + 1)
            + f'<SimplePredicate field="{field}" operator="{op}" value="{thr:.17g}" />'
        )

    def walk(node_id, tab, is_left, prev_idx):
        if node_id < 0:
            node_id = ~node_id
            score = tree.leaf_value[node_id]
            count = tree.leaf_count[node_id]
            is_leaf = True
        else:
            score = tree.internal_value[node_id]
            count = tree.internal_count[node_id]
            is_leaf = False
        lines.append(
            "\t" * tab
            + f'<Node id="{next(unique_id)}" score="{score:.17g}" recordCount="{count}">'
        )
        if prev_idx is not None:
            predicate(tab, node_id, is_left, prev_idx, is_leaf)
        else:
            lines.append("\t" * (tab + 1) + "<True />")
        if not is_leaf:
            walk(tree.left_child[node_id], tab + 1, True, node_id)
            walk(tree.right_child[node_id], tab + 1, False, node_id)
        lines.append("\t" * tab + "</Node>")

    if tree.num_leaves > 1:
        walk(0, 4, True, None)
    else:
        lines.append(
            "\t" * 4
            + f'<Node id="{next(unique_id)}" score="{tree.leaf_value[0]:.17g}" recordCount="0">'
        )
        lines.append("\t" * 5 + "<True />")
        lines.append("\t" * 4 + "</Node>")
    return lines


def model_to_pmml(booster: Booster, model_name: str = "LightGBM_tpu_model") -> str:
    """Booster -> PMML string (regression / binary, like the reference)."""
    b = booster.boosting
    obj = b.objective.name if b.objective is not None else "regression"
    if obj not in ("regression", "regression_l1", "huber", "fair", "poisson",
                   "binary"):
        Log.fatal("PMML export supports regression and binary objectives, got %s", obj)
    feature_names = b.feature_names or [
        f"Column_{i}" for i in range(b.max_feature_idx + 1)
    ]
    func = "classification" if obj == "binary" else "regression"

    out = [_HEADER]
    out.append("\t<DataDictionary>")
    for name in feature_names:
        out.append(
            f'\t\t<DataField name="{name}" optype="continuous" dataType="double"/>'
        )
    out.append('\t\t<DataField name="prediction" optype="continuous" dataType="double"/>')
    out.append("\t</DataDictionary>")
    out.append(
        f'\t<MiningModel modelName="{model_name}" functionName="regression">'
    )
    out.append("\t\t<MiningSchema>")
    for name in feature_names:
        out.append(f'\t\t\t<MiningField name="{name}"/>')
    out.append('\t\t\t<MiningField name="prediction" usageType="target"/>')
    out.append("\t\t</MiningSchema>")
    if obj == "binary":
        out.append("\t\t<Output>")
        out.append(
            '\t\t\t<OutputField name="probability" optype="continuous" '
            'dataType="double" feature="transformedValue">'
        )
        out.append(
            "\t\t\t\t<Apply function=\"/\"><NumericConstant>1</NumericConstant>"
            "<Apply function=\"+\"><NumericConstant>1</NumericConstant>"
            "<Apply function=\"exp\"><Apply function=\"*\">"
            "<NumericConstant>-1</NumericConstant>"
            "<FieldRef field=\"prediction\"/></Apply></Apply></Apply></Apply>"
        )
        out.append("\t\t\t</OutputField>")
        out.append("\t\t</Output>")
    out.append(
        '\t\t<Segmentation multipleModelMethod="sum">'
    )
    unique_id = itertools.count(1)
    for i, tree in enumerate(b.models):
        out.append(f'\t\t\t<Segment id="{i + 1}">')
        out.append("\t\t\t\t<True />")
        out.append(
            '\t\t\t\t<TreeModel functionName="regression" '
            'splitCharacteristic="binarySplit">'
        )
        out.append("\t\t\t\t\t<MiningSchema>")
        for name in feature_names:
            out.append(f'\t\t\t\t\t\t<MiningField name="{name}"/>')
        out.append("\t\t\t\t\t</MiningSchema>")
        out.extend(_tree_pmml(tree, feature_names, unique_id))
        out.append("\t\t\t\t</TreeModel>")
        out.append("\t\t\t</Segment>")
    out.append("\t\t</Segmentation>")
    out.append("\t</MiningModel>")
    out.append("</PMML>")
    return "\n".join(out) + "\n"


def pmml_from_model_file(model_path: str, out_path: Optional[str] = None,
                         device=None) -> str:
    """CLI-style conversion of a saved model file (pmml.py __main__); the
    Booster loads on ``device`` (None: the CUDA card)."""
    booster = Booster(model_file=model_path, device=device)
    pmml = model_to_pmml(booster)
    if out_path:
        with open(out_path, "w") as f:
            f.write(pmml)
    return pmml


if __name__ == "__main__":
    import sys

    if len(sys.argv) < 2:
        print("usage: python -m lightgbm_tpu_torch.pmml <model.txt> [out.pmml]")
        sys.exit(1)
    res = pmml_from_model_file(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
    if len(sys.argv) <= 2:
        print(res)
