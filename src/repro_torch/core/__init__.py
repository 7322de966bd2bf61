"""The paper's analytical model and its operator-level characterization,
ported from ``repro.core``: ``roofline`` (device specs, the H100's among
them, and the three-term roofline), ``analytical`` (the closed-form
operator inventory of Table 3 and the non-GEMM phases of Fig. 8),
``distmodel`` (the data- and model-parallel profiles of Fig. 12),
``optrace`` (``hlotext``'s counterpart: the op recorder, named scopes, the
taxonomy, the collective wire model) and ``characterize`` (the cost engine
over a recorded trace, bucketed by taxonomy and by scope). No kernel is
defined here; ``characterize.analyze`` runs the callable it is given."""
