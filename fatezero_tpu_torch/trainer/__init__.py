"""One-shot tuning: the DDPM trainer and the int8-state AdamW."""
