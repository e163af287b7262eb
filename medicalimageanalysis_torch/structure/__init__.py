"""Domain objects: Image and Rigid."""
