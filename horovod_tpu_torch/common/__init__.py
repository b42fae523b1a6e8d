"""Framework-neutral helpers of the port."""
