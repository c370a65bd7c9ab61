"""Distribution helpers of the port (one device so far)."""
