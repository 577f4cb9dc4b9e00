"""The NMPC controller facade."""
