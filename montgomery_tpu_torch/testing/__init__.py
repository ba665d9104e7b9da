"""Test helpers: the equivalence harness and adversarial generators."""
