"""Host-side data helpers of the port (image decode, normalize, palettes)."""
