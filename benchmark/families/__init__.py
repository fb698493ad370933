"""One driver per model family, found by a configuration's ``family``."""
