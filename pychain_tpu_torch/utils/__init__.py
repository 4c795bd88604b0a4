"""Test graphs, diagnostics, device selection and checkpoints."""
