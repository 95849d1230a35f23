"""Predict → measure for the stencil case study on the card."""
