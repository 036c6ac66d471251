"""Train state and the train and eval steps."""
