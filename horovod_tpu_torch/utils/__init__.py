"""Framework-neutral helpers of the port (environment configuration)."""
