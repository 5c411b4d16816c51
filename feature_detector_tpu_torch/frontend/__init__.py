"""Public detect / describe / match entry points."""
