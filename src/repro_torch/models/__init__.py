"""Model zoo of the port: the attention family's building blocks
(``modules``) and the unified LM (``transformer``)."""
