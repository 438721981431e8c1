"""Helpers of the port that hold no field arithmetic of their own."""
