# coding=utf-8
