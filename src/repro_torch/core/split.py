"""Split propagation over the ODG — a faithful port of Algorithm 1 (§4.2).

Split labels (``split_dim``, ``split_num``) live on tensors shared by
producer outputs and consumer inputs. The traversal walks the graph in
topological order; an operator generates partitioned tile tasks only when
every required input already carries the expected partition label, and
otherwise *falls back to one unsplit task* — preserving semantic correctness
at the cost of parallelism, exactly as the paper specifies.

Task counts are *plan-aware*: a node's ``task_num_fn`` takes (config,
operator), so the count reflects the nonzero cells of that rank's
:class:`~repro_torch.core.routing.RoutingPlan` rather than a fixed ``ep × e_loc``
grid. A rank with no routed rows legally gets zero tasks. Under
``gmm_split_mode="source_aligned"`` the counts come from source-cell-aligned
chunk grouping (``RoutingPlan.gmm_tiles``), which keeps the propagated
boundaries legal for arbitrarily imbalanced plans.
"""

from __future__ import annotations

from .odg import ODG, OperatorNode


def propagate_splits(g: ODG) -> None:
    """Run Algorithm 1 in place: fills ``op.task_num`` and tensor labels."""
    c = g.cfg

    # Lines 1-4: initialise split labels on every tensor.
    for t in g.tensors.values():
        t.split_dim = -1
        t.split_num = 1

    # Lines 5-25: topological traversal applying each node's SplitSpec.
    for op in g.topological():
        s = op.split_spec

        checked = s.split_inputs
        if checked is None:
            # Partitioning origin (e.g. Dispatch).
            n = s.task_num_fn(c, op)
        else:
            required = [(i, d) for (i, d) in checked
                        if i not in s.ignore_inputs]
            if all(op.inputs[i].split_dim == d for (i, d) in required):
                n = s.task_num_fn(c, op)
            else:
                n = 1  # fallback to one unsplit task

        op.task_num = n

        for j, y in enumerate(op.outputs):
            d = s.split_output_dims[j]
            if (n > 1 or s.always_label) and d >= 0:
                y.split_dim = d
                y.split_num = n          # visible to downstream inputs
            else:
                y.split_dim = -1
                y.split_num = n


def split_report(g: ODG) -> list[tuple[str, int]]:
    """(op name, task_num) for every operator — handy for tests/logging."""
    return [(op.name, op.task_num) for op in g.ops]
