"""Word error rate, WER evaluation and the submission writer."""
