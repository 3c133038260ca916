"""Host-side utilities: transfer and timing on the card, filter planes,
logging, tuning hints."""
