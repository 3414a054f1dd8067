"""Tools of the port that are not part of the aligner's CLI."""
