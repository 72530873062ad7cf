"""Static channel permute and local/remote split."""
