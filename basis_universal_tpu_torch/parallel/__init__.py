"""Multi-device helpers of the port (`mesh`)."""
