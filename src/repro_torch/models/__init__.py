"""Models (port of ``repro.models``): the shared layers, GQA attention, the
dense transformer stack and the sentence encoder that the text path serves."""
