"""Training-side modules of the port: AdamW and the schedules
(``optimizer``), the train step and driver (``train_loop``), the pytree
file format and train states (``checkpoints``, also the Zoo registry's
weight files), and the JSONL metrics logger (``metrics``) that the train
and serve CLIs write."""
