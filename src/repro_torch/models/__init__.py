"""Language models of the port (``repro.models``): the dense decoder LM."""
