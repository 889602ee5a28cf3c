"""Models (port of ``repro.models``): the shared layers, GQA and MLA
attention, the MoE, the transformer stack (LM serving and training), the
sentence encoder that the text path serves, the recsys towers and
GraphSAGE."""
