"""The harness: set-up, the measured window and its trace, and the check."""
