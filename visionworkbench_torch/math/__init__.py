"""Host-side math helpers of the port."""
