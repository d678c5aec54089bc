"""Single-device training for the port: synthetic data, AdamW, the train step."""
