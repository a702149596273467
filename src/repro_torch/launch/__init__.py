"""Launchers: the serve and train entry points and the meshes."""
