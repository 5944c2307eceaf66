"""Host-side data helpers: EMIT renormalisation, band normalisation, synthetic scenes."""
