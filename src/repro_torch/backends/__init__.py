"""Execution backends: ``local`` runs a lowered vec program eagerly on
torch tensors through the emitters in ``emit``."""
