"""The synthetic training data (``pipeline``), numpy only."""
