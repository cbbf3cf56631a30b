"""Host-side helpers of the port (prompt templates)."""
