"""Closed-loop and open-loop evaluators (the tuning objective engines)."""
