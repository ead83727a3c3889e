"""Architecture configs of the ported LM families."""
