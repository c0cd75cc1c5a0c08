"""The LM zoo's models (port of ``repro.models``): layers, attention
(GQA, MLA), Mamba2, MoE, and the model assembled from a config's
segments."""
