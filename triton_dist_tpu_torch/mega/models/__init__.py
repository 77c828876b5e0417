"""Model decode steps recorded as mega task graphs."""
