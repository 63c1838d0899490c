"""Host file layer."""
