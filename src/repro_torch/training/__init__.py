"""Training-side modules of the port; so far the pytree file format
(``checkpoints``) that the Zoo's registry stores weights in, and the
JSONL metrics logger (``metrics``) that the serve CLI writes."""
