"""The paper's analytical model, ported: ``roofline`` (device specs, the
H100's among them, and the three-term roofline), ``analytical`` (the
closed-form operator inventory of Table 3 and the non-GEMM phases of
Fig. 8) and ``distmodel`` (the data- and model-parallel profiles of
Fig. 12). Pure model code: no kernel runs here."""
