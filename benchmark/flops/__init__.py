"""The work a step needs, counted from shapes: one module per model family."""
