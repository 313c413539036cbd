"""Model -> C++ code generation — the PyTorch port's copy of
lightgbm_tpu/convert_model.py (its output is string-equal to the JAX
package's for the same model text), counterpart of GBDT::ModelToIfElse
(src/boosting/gbdt.cpp:738-827) and Tree::ToIfElse (src/io/tree.cpp:391-444),
reachable through the CLI as ``task=convert_model`` (application.cpp:268-273).

Unlike the reference's output (which slots into LightGBM's own build as a
replacement gbdt_prediction.cpp), the generated file here is SELF-
CONTAINED standard C++: it exposes

    extern "C" int  GetNumClasses();
    extern "C" int  GetNumFeatures();
    extern "C" void PredictRaw(const double* features, double* output);
    extern "C" void Predict(const double* features, double* output);

so it compiles with any toolchain (``g++ -O2 -shared -fPIC model.cpp``)
and needs no framework headers.

Decision semantics mirror Tree::NodeToIfElse + the missing-value remap
(tree.cpp:407-444, meta.h kMissingValueRange): a feature value in
(-1e-20, 1e-20] or NaN is replaced by the node's default_value before
the <= / == comparison."""

from __future__ import annotations

import numpy as np

from .io.binning import MISSING_VALUE_RANGE

_MISSING = repr(float(MISSING_VALUE_RANGE))


def _node_code(tree, root: int, leaf_index: bool, indent0: str) -> str:
    """Iterative emission (deep leaf-wise chains can exceed Python's
    recursion limit)."""
    out = []
    stack = [("node", root, indent0)]
    while stack:
        kind, node, indent = stack.pop()
        if kind == "text":
            out.append(node)
            continue
        if node < 0:  # leaf
            leaf = ~node
            val = leaf if leaf_index else repr(float(tree.leaf_value[leaf]))
            out.append(f"{indent}return {val};\n")
            continue
        f = int(tree.split_feature[node])
        dv = repr(float(tree.default_value[node]))
        fval = (
            f"(((arr[{f}] > -{_MISSING} && arr[{f}] <= {_MISSING})"
            f" || arr[{f}] != arr[{f}]) ? {dv} : arr[{f}])"
        )
        if tree.decision_type[node] == 1:
            # categorical: both sides truncate to integer first
            # (Tree::CategoricalDecision / tree.py:194 int64 semantics)
            thr = int(tree.threshold[node])
            cond = f"(long long)({fval}) == {thr}LL"
        else:
            thr = repr(float(tree.threshold[node]))
            cond = f"{fval} <= {thr}"
        out.append(f"{indent}if ({cond}) {{\n")
        stack.append(("text", f"{indent}}}\n", None))
        stack.append(("node", int(tree.right_child[node]), indent + "  "))
        stack.append(("text", f"{indent}}} else {{\n", None))
        stack.append(("node", int(tree.left_child[node]), indent + "  "))
    return "".join(out)


def _tree_fn(tree, i: int, leaf_index: bool) -> str:
    name = f"PredictTree{i}" + ("Leaf" if leaf_index else "")
    rtype = "int" if leaf_index else "double"
    body = (
        f"  return 0;\n"
        if tree.num_leaves <= 1
        else _node_code(tree, 0, leaf_index, "  ")
    )
    return f"static {rtype} {name}(const double* arr) {{\n{body}}}\n"


def model_to_cpp(boosting, num_iteration: int = -1) -> str:
    """Generate the standalone C++ predictor for a trained booster."""
    models = boosting._used_models(num_iteration)
    k = boosting.num_tree_per_iteration
    obj = boosting.objective
    convert = ""
    if obj is not None:
        name = obj.name
        if name == "binary" or name.startswith("multiclassova"):
            # per-output sigmoid (binary_objective.hpp ConvertOutput /
            # multiclass ova)
            sig = repr(float(getattr(obj, "sigmoid", 1.0)))
            convert = f"output[i] = 1.0 / (1.0 + std::exp(-{sig} * output[i]));"
        elif name in ("multiclass", "softmax"):
            convert = "/* softmax below */"
    lines = [
        "// Generated by lightgbm_tpu task=convert_model "
        "(GBDT::ModelToIfElse counterpart)",
        "#include <cmath>",
        "",
    ]
    for i, t in enumerate(models):
        lines.append(_tree_fn(t, i, False))
    for i, t in enumerate(models):
        lines.append(_tree_fn(t, i, True))
    n_models = len(models)
    ptrs = ", ".join(f"PredictTree{i}" for i in range(n_models)) or ""
    leaf_ptrs = ", ".join(f"PredictTree{i}Leaf" for i in range(n_models)) or ""
    softmax = ""
    if obj is not None and obj.name in ("multiclass", "softmax"):
        softmax = """
  double m = output[0];
  for (int i = 1; i < {k}; ++i) if (output[i] > m) m = output[i];
  double s = 0.0;
  for (int i = 0; i < {k}; ++i) {{ output[i] = std::exp(output[i] - m); s += output[i]; }}
  for (int i = 0; i < {k}; ++i) output[i] /= s;""".format(k=k)
    max_feat = boosting.max_feature_idx + 1
    lines.append(
        f"""typedef double (*TreeFn)(const double*);
typedef int (*LeafFn)(const double*);
static TreeFn kTrees[] = {{ {ptrs} }};
static LeafFn kLeafTrees[] = {{ {leaf_ptrs} }};
static const int kNumModels = {n_models};
static const int kNumClasses = {k};

extern "C" int GetNumClasses() {{ return kNumClasses; }}
extern "C" int GetNumFeatures() {{ return {max_feat}; }}

extern "C" void PredictRaw(const double* features, double* output) {{
  for (int i = 0; i < kNumClasses; ++i) output[i] = 0.0;
  for (int i = 0; i < kNumModels; ++i)
    output[i % kNumClasses] += kTrees[i](features);
}}

extern "C" void Predict(const double* features, double* output) {{
  PredictRaw(features, output);
  for (int i = 0; i < kNumClasses; ++i) {{
    {convert}
  }}{softmax}
}}

extern "C" void PredictLeafIndex(const double* features, int* output) {{
  for (int i = 0; i < kNumModels; ++i) output[i] = kLeafTrees[i](features);
}}
"""
    )
    return "\n".join(lines)
