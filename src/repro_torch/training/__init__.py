"""Training-side modules of the port; so far only the pytree file format
(``checkpoints``) that the Zoo's registry stores weights in."""
